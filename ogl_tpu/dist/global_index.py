"""Global index table — the gkoGlobalIndex equivalent
(DevicePersistent/IOGlobalIndex/gkoGlobalIndex.{H,C}): an offset table of
per-rank sizes with local<->global conversion and root-gather/scatter of
per-rank arrays.

Here the MPI Pstream gather/scatter becomes either host-side (numpy
concat/split — rank data is host-visible) or on-device all_gather; this
class provides the host-side table (used for rank-0-style IO collection)
while device-side collection goes through dist.solve's psum/all_gather.
"""

from __future__ import annotations

import numpy as np

__all__ = ["GlobalIndex"]


class GlobalIndex:
    def __init__(self, local_sizes):
        self.sizes = tuple(int(s) for s in local_sizes)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(np.int64)

    @property
    def total_size(self) -> int:
        return int(self.offsets[-1])

    def local_size(self, rank: int) -> int:
        return self.sizes[rank]

    def offset(self, rank: int) -> int:
        return int(self.offsets[rank])

    def to_global(self, rank: int, local_idx):
        """local -> global (gkoGlobalIndex::toGlobal)."""
        return np.asarray(local_idx) + self.offsets[rank]

    def to_local(self, rank: int, global_idx):
        return np.asarray(global_idx) - self.offsets[rank]

    def which_rank(self, global_idx):
        """owning rank per global index (gkoGlobalIndex::whichProcID).
        Out-of-range indices are an error (the reference asserts validity)."""
        g = np.asarray(global_idx)
        if np.any(g < 0) or np.any(g >= self.total_size):
            raise IndexError(
                f"global index out of range [0, {self.total_size})")
        return (np.searchsorted(self.offsets, g, side="right") - 1)

    def is_local(self, rank: int, global_idx):
        g = np.asarray(global_idx)
        return (g >= self.offsets[rank]) & (g < self.offsets[rank + 1])

    def gather(self, chunks):
        """Concatenate per-rank arrays into the global array
        (gkoGlobalIndex::gather onto the master rank)."""
        assert len(chunks) == len(self.sizes)
        for r, c in enumerate(chunks):
            assert len(c) == self.sizes[r], (r, len(c), self.sizes[r])
        return np.concatenate([np.asarray(c) for c in chunks])

    def scatter(self, full):
        """Split a global array into per-rank chunks (gkoGlobalIndex::scatter)."""
        full = np.asarray(full)
        assert len(full) == self.total_size
        return [full[self.offsets[r]:self.offsets[r + 1]] for r in range(len(self.sizes))]

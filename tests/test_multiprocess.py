"""Real multi-process distributed runtime: two OS processes, each with two
virtual CPU devices, form one 4-device mesh via jax.distributed and run the
shard_map'd distributed CG end-to-end (the jax equivalent of the
reference's `mpirun -np N` integration runs, integration-tests.yml)."""

import os
import socket
import subprocess
import sys



def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_cg():
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "multiproc_worker.py")
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    import uuid
    env["MP_RUN_ID"] = uuid.uuid4().hex[:8]
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coordinator, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
        assert f"OK {pid}" in out, out[-2000:]
        assert f"MPFOAM OK {pid}" in out, out[-2000:]
        assert f"MPEXPORT OK {pid}" in out, out[-2000:]
        assert f"MPGDIA OK {pid}" in out, out[-2000:]
        assert f"MPXELL OK {pid}" in out, out[-2000:]
        for pcn in ("ILU", "Multigrid"):
            assert f"MPSCHWARZ {pcn} OK {pid}" in out, out[-2000:]
    # identical adaptMinIter stopping params on every process (the
    # broadcast of the measured cost ratio, reference lduLduBase.H:291-293)
    params = sorted(
        line.split(" ", 2)[2]
        for out in outs for line in out.splitlines()
        if line.startswith("PARAMS "))
    assert len(params) == 2 and params[0] == params[1], params

"""Multi-process simulation: 2 processes x 4 CPU devices.

SURVEY.md §4's "multi-host tests via multi-process simulation on one
host": spawns two jax.distributed processes (tests/mp_worker.py), forming
one 8-device global mesh whose collectives cross the process boundary
(Gloo between the processes), and runs dist_scan / dist_sort /
dist_group_aggregate / the skew-replanning dist_hash_join across it.
"""

import os
import subprocess
import sys

def test_two_process_mesh():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "mp_worker.py")
    port = 21000 + os.getpid() % 9000
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    # no persistent-cache contention between the two fresh processes
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=repo) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=520)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-4000:]}"
        assert f"MP_OK_{pid}" in out, f"proc {pid} missing OK:\n{out[-4000:]}"

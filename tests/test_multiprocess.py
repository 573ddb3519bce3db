"""Multi-process (multi-host analogue) test: two OS processes join a
jax.distributed cluster over the CPU backend and run a collective — the
analogue of the reference's oversubscribed 4-rank mpirun ctest
(reference: test/CMakeLists.txt:317-325).  Exercises the node.py
multi-process initialization path end-to-end."""

import os
import subprocess
import sys

import pytest

_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

pid = int(sys.argv[1])
port = sys.argv[2]

from starneig_jax import node
node.node_init(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
               process_id=pid)

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

devs = jax.devices()          # global view: one cpu device per process
assert len(devs) == 2, f"expected 2 global devices, got {len(devs)}"
mesh = Mesh(np.array(devs), ("d",))

# build a process-local shard and run a global psum through shard_map
local = jnp.full((4,), float(pid + 1))
arr = jax.make_array_from_single_device_arrays(
    (8,), NamedSharding(mesh, P("d")),
    [jax.device_put(local, jax.local_devices()[0])])

def f(x):
    return jax.lax.psum(jnp.sum(x), "d")

out = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("d"),
                            out_specs=P()))(arr)
# sum over both shards: 4*1 + 4*2 = 12
val = float(np.asarray(jax.device_get(out)))
assert abs(val - 12.0) < 1e-12, val
node.node_finalize()
print(f"proc {pid} ok", flush=True)
"""


def test_two_process_distributed(tmp_path):
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # exactly one CPU device per process
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i} ok" in out

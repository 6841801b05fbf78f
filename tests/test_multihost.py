"""Multi-host path: two REAL jax.distributed processes on the CPU
backend — the test analog of a 2-host pod slice (the reference has no
multi-host; SURVEY.md §2 'Distributed communication backend' specifies
this design: encode local, all-gather only metadata across hosts)."""

import json
import os
import socket
import subprocess
import sys
import zlib

import pytest

_WORKER = r"""
import json, os, sys, zlib
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); coord = sys.argv[3]

from libdeflate_rsx_tpu.parallel import multihost as mh

mh.initialize(coordinator_address=coord, num_processes=nproc,
              process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == nproc * len(jax.local_devices())

# the global batch (identical on every host, like a work manifest)
batch = [bytes([66 + i]) * 20000 + bytes(range(256)) * (40 + i)
         for i in range(5)]
outs = mh.compress_local_shard(batch)
local = mh.process_local_batch(batch)
for d, o in zip(local, outs):
    assert zlib.decompress(o, -15) == d

# the cross-host collective: global per-host compressed totals
local_total = sum(len(o) for o in outs)
sizes = mh.global_sizes(local_total)

# ordered payload gather: every host must emit the IDENTICAL,
# externally-valid global gzip container (round-2 VERDICT item 5)
import gzip, hashlib
gdata = bytes([7 * i % 251 for i in range(300_000)]) + b"tail" * 999
gout = mh.compress_global(gdata, "gzip", block_size=65536)
assert gzip.decompress(gout) == gdata
zout = mh.compress_global(gdata, "zlib", block_size=65536)
assert zlib.decompress(zout) == gdata
print(json.dumps({"pid": pid,
                  "n_local": len(outs),
                  "local_total": local_total,
                  "global_sizes": [int(s) for s in sizes],
                  "gzip_sha": hashlib.sha256(gout).hexdigest(),
                  "zlib_sha": hashlib.sha256(zout).hexdigest()}),
      flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_compress():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(pid), "2", coord],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(2)
    ]
    results = {}
    for p in procs:
        out, err = p.communicate(timeout=220)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        line = [l for l in out.splitlines() if l.startswith("{")][-1]
        r = json.loads(line)
        results[r["pid"]] = r

    assert set(results) == {0, 1}
    # round-robin split of 5 items: 3 + 2
    assert results[0]["n_local"] == 3 and results[1]["n_local"] == 2
    # both hosts observed the SAME global size vector, and it matches
    # the per-host local totals — the cross-host all-gather worked
    g0, g1 = results[0]["global_sizes"], results[1]["global_sizes"]
    assert g0 == g1
    assert g0 == [results[0]["local_total"], results[1]["local_total"]]
    # both hosts emitted the byte-identical global containers (each
    # worker already verified external decodability)
    assert results[0]["gzip_sha"] == results[1]["gzip_sha"]
    assert results[0]["zlib_sha"] == results[1]["zlib_sha"]

"""Two-process ``jax.distributed`` integration: both processes join one
runtime, process disjoint host shards of the same survey, and the merged
shard catalogs equal the single-process catalog bit for bit
(reference's cluster pattern: slurm/submit_gp_find_lls.sh:7-13 +
CDDF_analysis/sbatch_reunion.py:13-63)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "distributed_runner.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_shard_merge_equals_single_process(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # one CPU device per process — no virtual-device fan-out here
    env["XLA_FLAGS"] = ""
    env["PYTHONPATH"] = REPO

    procs = [
        subprocess.Popen(
            [sys.executable, RUNNER, str(port), str(pid), "2", str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outputs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, out[-3000:]

    shard0 = str(tmp_path / "processed.shard0000.h5")
    shard1 = str(tmp_path / "processed.shard0001.h5")
    assert os.path.exists(shard0) and os.path.exists(shard1), outputs

    from gpy_dla_detection_tpu.analysis.catalog_tools import merge_catalogs

    merged = str(tmp_path / "merged.h5")
    total = merge_catalogs([shard0, shard1], merged)
    assert total == 4

    # single-process run over all batches, in an identical environment
    single = str(tmp_path / "single.h5")
    out = subprocess.run(
        [sys.executable, RUNNER, str(port), "0", "1", str(tmp_path)],
        env=env,
        capture_output=True,
        timeout=600,
    )
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]

    with h5py.File(merged, "r") as fm, h5py.File(single, "r") as fs:
        assert set(fm.keys()) == set(fs.keys())
        for name in fs.keys():
            a, b = fm[name][()], fs[name][()]
            if a.dtype.kind in "OSU":
                assert list(a) == list(b), name
            else:
                # bit-for-bit: same partition, same per-batch keys, same
                # deterministic CPU executable
                assert np.array_equal(a, b, equal_nan=True), (
                    name,
                    np.nanmax(np.abs(a - b)),
                )

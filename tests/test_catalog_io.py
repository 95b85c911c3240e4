"""The processed catalog in its two containers: ``.h5`` through h5py
(the reference's format) and ``.npz`` through numpy alone."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from gpy_dla_detection_tpu.catalog_io import read_catalog, write_catalog
from gpy_dla_detection_tpu.data.samples import (
    generate_dla_samples,
    generate_subdla_samples,
)
from gpy_dla_detection_tpu.data.synthetic import (
    synthetic_learned_model,
    synthetic_prior_catalog,
    synthetic_spectrum,
)
from gpy_dla_detection_tpu.parallel.batch import process_batch
from gpy_dla_detection_tpu.params import Parameters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def results():
    params = Parameters(num_dla_samples=100)
    learned = synthetic_learned_model(params)
    out = process_batch(
        learned,
        [synthetic_spectrum(params, learned, z, seed=i)
         for i, z in enumerate([2.9, 3.2])],
        generate_dla_samples(params),
        generate_subdla_samples(params),
        synthetic_prior_catalog(params),
        params,
        jax.random.PRNGKey(0),
        2,
    )
    return params, out


@pytest.mark.parametrize("exceptions", [None, [7]])
def test_npz_and_h5_catalogs_hold_identical_arrays(results, tmp_path, exceptions):
    params, out = results
    names = ["spec-a.fits", "spec-ü.fits"]
    cats = {}
    for suffix in (".npz", ".h5"):
        path = str(tmp_path / f"catalog{suffix}")
        write_catalog(path, out, params, 2, [2.9, 3.2], names, exceptions)
        cats[suffix] = read_catalog(path)
    a, b = cats[".npz"], cats[".h5"]
    assert sorted(a) == sorted(b)
    assert ("all_exceptions" in a) == bool(exceptions)
    for name in a:
        assert a[name].shape == b[name].shape, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert list(a["qso_list"]) == names
    assert a["sample_log_likelihoods_dla"].shape == (2, 100, 2)


def test_npz_catalog_main_path_imports_only_jax_numpy_scipy(tmp_path):
    """The CLI writing a .npz catalog runs with h5py and matplotlib
    unimportable, and imports no third-party package beyond what JAX
    itself loads, numpy and scipy."""
    from gpy_dla_detection_tpu.data.fits import write_speclite
    from gpy_dla_detection_tpu.data.synthetic import synthetic_observation

    params = Parameters()
    learned = synthetic_learned_model(params)
    files = []
    for i, z in enumerate([2.9, 3.3]):
        wl, fx, nv, pm = synthetic_observation(params, learned, z, seed=i)
        files.append(str(tmp_path / f"spec-0001-55555-{i:04d}.fits"))
        write_speclite(files[-1], fx.astype(np.float32),
                       np.log10(wl).astype(np.float32),
                       (1.0 / nv).astype(np.float32),
                       np.where(pm, 1 << 24, 0).astype(np.int32))
    child = f"""
import sys
for blocked in ("h5py", "matplotlib"):
    sys.modules[blocked] = None  # import raises ImportError
# what JAX, numpy and scipy themselves load (JAX compiling and running
# through the compile cache)
import numpy, scipy.interpolate, scipy.linalg, scipy.optimize, scipy.special
import scipy.stats
import jax, jax.numpy as jnp
from gpy_dla_detection_tpu.utils.compile_cache import configure_compile_cache
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
configure_compile_cache()
jax.jit(lambda x: jnp.sin(x) @ x)(jnp.ones((4, 4))).block_until_ready()
baseline = {{m.split(".")[0] for m in sys.modules}}
from gpy_dla_detection_tpu import run_bayes_select
run_bayes_select.main({
    ["--qso_list", *files, "--z_qso_list", "2.9", "3.3", "--max_dlas", "2",
     "--num-samples", "64", "--batch-size", "2",
     "--output", str(tmp_path / "catalog.npz")]!r})
allowed = baseline | set(sys.stdlib_module_names) | {{"gpy_dla_detection_tpu"}}
extra = sorted({{m.split(".")[0] for m in sys.modules}} - allowed - {{"__main__"}})
print("EXTRA_MODULES", extra)
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"))
    out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "EXTRA_MODULES []" in out.stdout, out.stdout[-2000:]
    cat = read_catalog(str(tmp_path / "catalog.npz"))
    assert cat["p_dlas"].shape == (2,)

"""Shared runtime utilities: the bounded batched-dispatch pipeline and
the identity-keyed device-table memo."""

import os

import numpy as np
import pytest

from gpy_dla_detection_tpu.utils.memo import memo_by_identity
from gpy_dla_detection_tpu.utils.pipeline import pipelined_batches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pipelined_batches_order_padding_and_aux():
    dispatched = []

    def dispatch_fn(chunk, chunk_aux):
        assert len(chunk) == 4  # every batch padded to one shape
        assert chunk_aux is not None and len(chunk_aux) == 4
        dispatched.append((list(chunk), list(chunk_aux)))
        return np.asarray(chunk) * 10 + np.asarray(chunk_aux)

    def finalize_fn(n_real, out):
        for i in range(n_real):
            yield int(out[i])

    items = list(range(10))
    aux = iter(range(100, 200))  # consumed lazily, one per item
    results = pipelined_batches(
        items, batch_size=4, max_in_flight=1,
        dispatch_fn=dispatch_fn, finalize_fn=finalize_fn, aux=aux,
    )
    # per-item results in stream order, padding results dropped
    assert results == [i * 10 + 100 + i for i in range(10)]
    assert len(dispatched) == 3
    # the short final batch repeats its last item AND its last aux
    assert dispatched[-1][0] == [8, 9, 9, 9]
    assert dispatched[-1][1] == [108, 109, 109, 109]
    # aux was consumed exactly once per real item
    assert next(aux) == 110


def test_pipelined_batches_without_aux():
    calls = []

    def dispatch_fn(chunk, chunk_aux):
        assert chunk_aux is None
        calls.append(list(chunk))
        return list(chunk)

    results = pipelined_batches(
        [1, 2, 3], batch_size=2, max_in_flight=8,
        dispatch_fn=dispatch_fn,
        finalize_fn=lambda n, out: out[:n],
    )
    assert results == [1, 2, 3]
    assert calls == [[1, 2], [3, 3]]


def test_memo_by_identity_hit_rebuild_and_eviction():
    cache: dict = {}
    owner_a = object()
    builds = []

    def build(tag):
        def _b():
            builds.append(tag)
            return tag
        return _b

    key_a = (id(owner_a), "x")
    assert memo_by_identity(cache, key_a, owner_a, build("a")) == "a"
    # hit: same key, same owner -> no rebuild
    assert memo_by_identity(cache, key_a, owner_a, build("a2")) == "a"
    assert builds == ["a"]
    # id() reuse: same key but a DIFFERENT owner object must rebuild
    owner_b = object()
    assert memo_by_identity(cache, key_a, owner_b, build("b")) == "b"
    assert builds == ["a", "b"]
    # FIFO eviction bounds the cache
    for i in range(20):
        o = object()
        memo_by_identity(cache, (id(o), i), o, build(i), max_entries=4)
    assert len(cache) <= 5  # 4 + the one just inserted before eviction


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_compile_cache_directory(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is used as it is and nothing
    is changed; otherwise the cache goes to <checkout>/.jax_cache."""
    import jax

    from gpy_dla_detection_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", "untouched")
            assert compile_cache.configure_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == "untouched"
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(REPO, ".jax_cache")
            assert compile_cache.configure_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)

"""Bounded-window batched dispatch pipeline over an item stream.

Shared scaffolding of the batched per-spectrum heads
(models/lls.py:lls_inference_many, models/civ.py:civ_inference_many):
chunk the incoming spectra into fixed-size batches (one compiled
shape — the final short batch is padded by repeating its last
element and the padding results dropped), keep up to ``max_in_flight``
dispatched batches in flight ahead of the readback (bounding device
memory while hiding the readback latency), and start every
result leaf's device->host copy asynchronously so per-array transfer
latencies overlap instead of summing.
"""

from __future__ import annotations

import collections

import jax


def pipelined_batches(
    items,
    batch_size: int,
    max_in_flight: int,
    dispatch_fn,
    finalize_fn,
    aux=None,
):
    """Run ``items`` through ``dispatch_fn`` in padded batches with a
    bounded in-flight window; collect ``finalize_fn``'s per-item
    results in stream order.

    :param items: any iterable (e.g. a prefetching generator).
    :param dispatch_fn: ``(chunk: list, chunk_aux: list | None) ->
        device pytree`` — must return promptly (async jax dispatch).
    :param finalize_fn: ``(n_real: int, out: device pytree) ->
        iterable`` of the first ``n_real`` per-item results (the rest
        of the batch is padding).
    :param aux: optional iterable yielding one auxiliary value per item
        (e.g. a PRNG key chain), consumed lazily in stream order.
    :return: list of per-item results.
    """
    it_aux = iter(aux) if aux is not None else None
    in_flight: collections.deque = collections.deque()
    results: list = []

    def drain_one():
        n_real, out = in_flight.popleft()
        results.extend(finalize_fn(n_real, out))

    def dispatch(chunk, chunk_aux):
        n_real = len(chunk)
        while len(chunk) < batch_size:  # pad: one compiled shape
            chunk.append(chunk[-1])
            if chunk_aux is not None:
                chunk_aux.append(chunk_aux[-1])
        out = dispatch_fn(chunk, chunk_aux)
        for leaf in jax.tree.leaves(out):
            try:
                leaf.copy_to_host_async()
            except AttributeError:
                pass
        in_flight.append((n_real, out))
        if len(in_flight) > max_in_flight:
            drain_one()

    chunk: list = []
    chunk_aux: list | None = [] if it_aux is not None else None
    for item in items:
        chunk.append(item)
        if it_aux is not None:
            chunk_aux.append(next(it_aux))
        if len(chunk) == batch_size:
            dispatch(chunk, chunk_aux)
            chunk = []
            chunk_aux = [] if it_aux is not None else None
    if chunk:
        dispatch(chunk, chunk_aux)
    while in_flight:
        drain_one()
    return results

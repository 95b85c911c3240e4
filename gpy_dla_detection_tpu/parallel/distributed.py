"""Multi-host orchestration.

The reference scales across machines with SLURM job arrays writing
independent shard files merged offline (reference:
slurm/submit_gp_find_lls.sh:7-13, CDDF_analysis/sbatch_reunion.py).
The JAX equivalent: one JAX process per host joined through
``jax.distributed``, the global device mesh spanning all hosts (data
parallel over spectra),
plus the same shard-file pattern for fault tolerance — a failed host's
shard is simply re-run and ``analysis.catalog_tools.merge_catalogs``
assembles the survey catalog.
"""

from __future__ import annotations

import os


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the multi-host JAX runtime (no-op if single-process)."""
    import jax

    if num_processes is None:
        num_processes = int(os.environ.get("GPY_DLA_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("GPY_DLA_COORDINATOR", "localhost:9731"),
        num_processes=num_processes,
        process_id=process_id
        if process_id is not None
        else int(os.environ.get("GPY_DLA_PROCESS_ID", "0")),
    )


def host_shard(items: list, process_id: int | None = None,
               num_processes: int | None = None) -> list:
    """This host's contiguous slice of a global work list."""
    import jax

    pid = process_id if process_id is not None else jax.process_index()
    n = num_processes if num_processes is not None else jax.process_count()
    per = -(-len(items) // n)
    return items[pid * per : (pid + 1) * per]


def shard_filename(base: str, process_id: int | None = None) -> str:
    """Per-host output file name, merged later by merge_catalogs."""
    import jax

    pid = process_id if process_id is not None else jax.process_index()
    root, ext = os.path.splitext(base)
    return f"{root}.shard{pid:04d}{ext}"

"""repro_torch.sweep: resumable experiment grids over the port's ``api``.

``Sweep`` declares a grid of RunSpecs (axes cross-product + presets, keyed
exactly as the JAX package keys them), ``SweepRunner`` executes it through
``Session`` on one device into a content-hash-keyed JSONL ``ResultsStore``
under ``results/torch/`` (interruption-safe: completed cells are skipped on
re-run), and ``report`` renders the store into marker-delimited markdown
tables.
"""

from repro_torch.sweep.grid import (  # noqa: F401
    Axis,
    Cell,
    PRESETS,
    Sweep,
    cell_key,
    get_preset,
)
from repro_torch.sweep.runner import (  # noqa: F401
    ResultsStore,
    SweepRunner,
    execute_cell,
    git_sha,
)
from repro_torch.sweep.report import (  # noqa: F401
    render_tables,
    update_markers,
    write_experiments,
)

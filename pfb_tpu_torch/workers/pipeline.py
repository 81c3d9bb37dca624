"""Pipeline recipes: chain workers from a YAML file (counterpart of
pfb_tpu/workers/pipeline.py).

    # recipe.yaml
    steps:
      - worker: init
        params: {ms: obs.npz, output-filename: out,
                 channels-per-image: 1}
      - worker: grid
        params: {output-filename: out, field-of-view: 0.4,
                 robustness: 0.0}
      - worker: klean
        params: {output-filename: out, niter: 10}
      - worker: restore
        params: {output-filename: out}

    python -m pfb_tpu_torch.workers.main --device cpu pipeline recipe.yaml

Parameters use the schema names ('-' separated); unknown workers or
parameters raise before anything runs. Each step logs "step i/n: worker"
on the PIPELINE logger before it runs.
"""

import yaml

from pfb_tpu_torch.parser.schemas import defaults_for, schema

_WORKERS = {
    "init": ("pfb_tpu_torch.workers.init", "_init"),
    "grid": ("pfb_tpu_torch.workers.grid", "_grid"),
    "klean": ("pfb_tpu_torch.workers.klean", "_klean"),
    "spotless": ("pfb_tpu_torch.workers.spotless", "_spotless"),
    "fwdbwd": ("pfb_tpu_torch.workers.fwdbwd", "_fwdbwd"),
    "fluxmop": ("pfb_tpu_torch.workers.fluxmop", "_fluxmop"),
    "model2comps": ("pfb_tpu_torch.workers.model2comps", "_model2comps"),
    "degrid": ("pfb_tpu_torch.workers.degrid", "_degrid"),
    "restore": ("pfb_tpu_torch.workers.restore", "_restore"),
    "fastim": ("pfb_tpu_torch.workers.fastim", "_fastim"),
    "smoovie": ("pfb_tpu_torch.workers.smoovie", "_smoovie"),
}

# schema options whose worker argument has another name
_RENAMED = {"filter_extreme_counts": "filter_extreme_counts_flag"}


def worker_args(worker, params):
    """The worker's keyword arguments: its schema defaults overlaid with
    ``params`` (names with '_' or '-'), schema names renamed where the
    worker's argument differs."""
    args = defaults_for(worker)
    args.update({k.replace("-", "_"): v for k, v in params.items()})
    for old, new in _RENAMED.items():
        if old in args:
            args[new] = args.pop(old)
    return args


def load_recipe(path):
    """The recipe's steps, each checked before any runs: a known worker
    and parameters its schema names."""
    with open(path) as f:
        recipe = yaml.safe_load(f)
    steps = recipe.get("steps", [])
    for i, step in enumerate(steps):
        worker = step.get("worker")
        if worker not in _WORKERS:
            raise ValueError(
                f"step {i}: unknown worker {worker!r}; "
                f"known: {sorted(_WORKERS)}")
        spec = getattr(schema, worker, None)
        known = {k.replace("-", "_")
                 for k in (spec or {}).get("inputs", {})}
        for key in step.get("params") or {}:
            if known and key.replace("-", "_") not in known:
                raise ValueError(
                    f"step {i} ({worker}): unknown parameter {key!r}")
    return steps


def resolve_recipe(path):
    """[(worker, kwargs)] of the recipe's steps, as :func:`run_recipe`
    passes them (without ``device``)."""
    return [(s["worker"], worker_args(s["worker"], s.get("params") or {}))
            for s in load_recipe(path)]


def run_recipe(path, verbose=1, device=None):
    """Execute a recipe on ``device`` (None: the card when one is
    visible); returns the list of per-step results."""
    import importlib

    steps = resolve_recipe(path)
    results = []
    for i, (worker, args) in enumerate(steps):
        mod_name, fn_name = _WORKERS[worker]
        fn = getattr(importlib.import_module(mod_name), fn_name)
        if verbose:
            from pfb_tpu_torch.utils.logging import get_logger
            get_logger("PIPELINE").info(
                f"step {i + 1}/{len(steps)}: {worker}")
        results.append(fn(device=device, **args))
    return results

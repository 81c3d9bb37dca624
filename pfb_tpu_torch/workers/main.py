"""pfb-tpu-torch CLI (counterpart of pfb_tpu/workers/main.py).

One click group with a sub-command per worker, options generated from the
YAML schemas in pfb_tpu_torch/parser/, and ``pipeline`` for recipes:

    python -m pfb_tpu_torch.workers.main --device cpu init -ms obs.npz -o out
    python -m pfb_tpu_torch.workers.main pipeline recipe.yaml

The group's ``--device`` (default: the card when one is visible, else the
CPU) reaches every worker's ``device`` argument.
"""

import click

from pfb_tpu_torch.parser.schemas import schema

_DTYPES = {"str": str, "int": int, "float": float, "bool": bool}

# worker -> the help line of its command (the JAX CLI's commands; concat
# and cubes have none)
_COMMANDS = {
    "init": "Create a Stokes visibility store from an MS.",
    "grid": "Grid visibilities to dirty/PSF image products.",
    "klean": "Modified single-scale CLEAN.",
    "spotless": "SARA wavelet-sparsity deconvolution.",
    "model2comps": "Fit the model cube to a continuous parametrisation.",
    "degrid": "Render the component model to model visibilities.",
    "restore": "Write restored FITS image products.",
    "fluxmop": "Standalone forward (PCG) step.",
    "fastim": "High-cadence residual snapshot imaging.",
    "smoovie": "Render fds snapshots to a movie.",
    "fwdbwd": "Generalised forward-backward with nonlinear "
              "parametrisation.",
}


def _clickify(worker):
    """Decorate a command with options from the worker's schema."""
    spec = getattr(schema, worker)

    def deco(fn):
        for key, field in reversed(list(spec.get("inputs", {}).items())):
            opt = f"--{key}"
            names = [opt]
            if field.get("abbreviation"):
                names.append(f"-{field['abbreviation']}")
            dtype = _DTYPES.get(field.get("dtype", "str"), str)
            if dtype is bool:
                fn = click.option(opt + "/--no-" + key,
                                  default=field.get("default", False),
                                  help=field.get("info", ""))(fn)
            else:
                fn = click.option(*names, type=dtype,
                                  default=field.get("default"),
                                  required=field.get("required", False),
                                  show_default=True,
                                  help=field.get("info", ""))(fn)
        return fn

    return deco


@click.group()
@click.option("--profile-dir", default=None,
              help="Write a torch.profiler Chrome trace of this worker run "
                   "under DIR (one trace per invocation).")
@click.option("--coordinator", default=None,
              help="host:port of process 0 for a multi-process run "
                   "(torch.distributed over gloo).")
@click.option("--num-processes", type=int, default=None,
              help="Total process count of the multi-process run.")
@click.option("--process-id", type=int, default=None,
              help="This process's index in the multi-process run.")
@click.option("--device", default=None,
              help="torch device of every worker, e.g. cuda:0 or cpu "
                   "(default: the card when one is visible, else the CPU).")
@click.pass_context
def cli(ctx, profile_dir, coordinator, num_processes, process_id, device):
    """pfb-tpu-torch: the PyTorch/CUDA radio-interferometric imaging
    suite."""
    ctx.obj = {"device": device}
    if profile_dir:
        from pfb_tpu_torch.utils.profiling import start_profile
        start_profile(profile_dir)
    if coordinator:
        from pfb_tpu_torch.parallel.runtime import set_client
        set_client(coordinator=coordinator, num_processes=num_processes,
                   process_id=process_id,
                   devices=None if device is None else [device])


def _args(worker, kw):
    """Schema defaults overlaid with the CLI's non-None options; pops
    log-directory and attaches the per-run file log there."""
    import os
    import time as _time

    from pfb_tpu_torch.workers.pipeline import worker_args

    args = worker_args(worker, {k: v for k, v in kw.items()
                                if v is not None})
    ldir = args.pop("log_directory", None)
    if ldir:
        os.makedirs(ldir, exist_ok=True)
        from pfb_tpu_torch.utils.logging import log_to_file
        stamp = _time.strftime("%Y%m%d-%H%M%S")
        log_to_file(os.path.join(ldir, f"{worker}_{stamp}.log"))
    return args


def _command(worker, doc):
    """The click command that runs ``worker`` on the group's device."""
    def run(obj, **kw):
        import importlib

        from pfb_tpu_torch.workers.pipeline import _WORKERS
        mod_name, fn_name = _WORKERS[worker]
        fn = getattr(importlib.import_module(mod_name), fn_name)
        fn(device=obj["device"], **_args(worker, kw))

    run.__doc__ = doc
    run.__name__ = worker
    return cli.command(name=worker)(click.pass_obj(_clickify(worker)(run)))


for _w, _doc in _COMMANDS.items():
    globals()[_w] = _command(_w, _doc)


@cli.command()
@click.argument("recipe", type=click.Path(exists=True))
@click.pass_obj
def pipeline(obj, recipe):
    """Run a YAML pipeline recipe (chained workers)."""
    from pfb_tpu_torch.workers.pipeline import run_recipe
    run_recipe(recipe, device=obj["device"])


if __name__ == "__main__":
    cli()

"""What every unit of this configuration's traffic starts from: the
observation's columns made from the seed (harness/simobs.py), and the
port's ``_init`` and ``_grid`` on them (dirty image, PSF, Briggs
weights), as a user's imaging run makes them before deconvolution. The
reference side works out the same again from the columns alone."""


def gridded(cfg, seed, device):
    """(columns, gridded datasets) of the configuration ``cfg``."""
    from harness.simobs import observation
    from pfb_tpu_torch.workers.grid import _grid
    from pfb_tpu_torch.workers.init import _init
    cols, _ = observation(cfg, seed)
    xds = _init(ms=cols, write=False, device=device,
                precision=cfg["precision"], channels_per_image=1)
    dds = _grid(xdsi=xds, write=False, device=device,
                backend=cfg["backend"], nx=cfg["nx"], ny=cfg["nx"],
                epsilon=cfg["epsilon"], robustness=cfg["robustness"],
                super_resolution_factor=cfg["srf"],
                psf_oversize=cfg["psf_oversize"], psf=True, residual=False)
    return cols, dds


def observe(inputs, cfg, device):
    """The reference's dirty image, PSF and exact Hessian
    (reference/imaging.py), worked out from the observation's columns on
    ``device`` in float64."""
    from reference.imaging import from_config
    return from_config(inputs["cols"], cfg, device)

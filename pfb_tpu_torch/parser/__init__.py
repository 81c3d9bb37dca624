"""Worker parameter schemas of the port's CLI (counterpart of
pfb_tpu/parser): the per-worker YAML files, their option mixins and the
stimela cabs, copied from the JAX package with the cabs' commands
pointed at pfb_tpu_torch.workers.main."""

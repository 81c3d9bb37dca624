"""Continuous component models (the mds contract): a host copy of
pfb_tpu/models, so the port fits and renders models without JAX."""

from pfb_tpu_torch.models.comps import (eval_coeffs_to_cube,
                                        eval_coeffs_to_slice,
                                        fit_image_cube)

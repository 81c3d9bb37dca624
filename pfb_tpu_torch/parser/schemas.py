"""Worker parameter schemas (counterpart of pfb_tpu/parser/schemas.py).

Every ``pfb_tpu_torch/parser/<worker>.yaml`` holds ``inputs: {name:
{dtype, default, info, abbreviation}}``; :data:`schema` exposes them as
attribute-style objects, and :func:`defaults_for` produces the kwargs
dict the workers, the CLI and the pipeline recipes consume.
"""

import glob
import os
from types import SimpleNamespace

import yaml

_here = os.path.dirname(__file__)


class _Schema(SimpleNamespace):
    def __getitem__(self, key):
        return getattr(self, key)


def _read(path):
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _load():
    out = {}
    for path in sorted(glob.glob(os.path.join(_here, "*.yaml"))):
        name = os.path.splitext(os.path.basename(path))[0]
        spec = _read(path)
        inputs = spec.get("inputs") or {}
        # shared option mixins: a worker yaml lists mixin .yml files under
        # inputs._include; mixin options merge in but the worker's own
        # definitions win
        include = inputs.pop("_include", None) or []
        if isinstance(include, str):
            include = [include]
        merged = {}
        for mixin in include:
            merged.update(_read(os.path.join(_here, mixin)))
        merged.update(inputs)
        if merged:
            spec["inputs"] = merged
        out[name] = spec
    return _Schema(**out)


schema = _load()


def defaults_for(worker: str) -> dict:
    """kwargs dict of defaults for a worker, '-' replaced by '_'."""
    spec = getattr(schema, worker)
    out = {}
    for key, field in spec.get("inputs", {}).items():
        out[key.replace("-", "_")] = field.get("default")
    return out

"""Weight bridge from the JAX package's flax parameters to the port.

``vivit_state_dict_from_flax`` is the inverse of the torch -> flax copy in
``tests/parity_helpers.py`` (``load_vivit_encoder``): the port's ViViT keeps
the flax submodule names, so the mapping is per leaf only —

  * a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), transposed;
  * a LayerNorm ``scale`` becomes ``weight``;
  * everything else (biases, ``space_token``, ``temporal_token``,
    ``pos_embedding``) is copied as it is.

``spatial_weights_from_flax`` converts the JAX package's ``SpatialWeights``
bundle (kernels (in, out), vectors (1, D)) into the port's bundle.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .ops.spatial_table import SpatialWeights, as_f32_tensor


def _tensor(x, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return as_f32_tensor(x).to(dtype)


def vivit_state_dict_from_flax(params: Mapping, prefix: str = "") -> dict:
    """flax params tree (``variables["params"]`` as nested dicts of numpy
    arrays) -> ``state_dict`` of the port module with the same structure."""
    out = {}
    for name, value in params.items():
        if isinstance(value, Mapping):
            out.update(vivit_state_dict_from_flax(value, f"{prefix}{name}."))
        elif name == "kernel":
            out[f"{prefix}weight"] = _tensor(value).T.contiguous()
        elif name == "scale":
            out[f"{prefix}weight"] = _tensor(value)
        else:
            out[f"{prefix}{name}"] = _tensor(value)
    return out


def spatial_weights_from_flax(bundle, dtype: torch.dtype = torch.bfloat16) -> SpatialWeights:
    """The JAX package's ``SpatialWeights`` (numpy leaves) -> the port's
    bundle: matrices transposed to (out, in), vectors flattened, matrices,
    biases and ``base`` in ``dtype``, LayerNorm parameters in f32."""
    mat = lambda w: _tensor(w, dtype).T.contiguous()
    vec = lambda v, dt=dtype: _tensor(v, dt).reshape(-1)
    ln = lambda v: vec(v, torch.float32)
    per_layer = {"w_qkv": mat, "w_out": mat, "w_ff1": mat, "w_ff2": mat,
                 "b_out": vec, "b_ff1": vec, "b_ff2": vec,
                 "ln_a_s": ln, "ln_a_b": ln, "ln_f_s": ln, "ln_f_b": ln}
    fields = {name: tuple(fn(w) for w in getattr(bundle, name))
              for name, fn in per_layer.items()}
    return SpatialWeights(base=_tensor(bundle.base, dtype),
                          ln_fin_s=ln(bundle.ln_fin_s),
                          ln_fin_b=ln(bundle.ln_fin_b), **fields)

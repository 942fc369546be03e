"""Weight bridge from the JAX package's flax parameters to the port.

``state_dict_from_flax`` is the inverse of the torch -> flax copy in
``tests/parity_helpers.py`` (``load_vivit_encoder``): the port's models keep
the flax submodule names, so the mapping is per leaf only —

  * a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), transposed;
  * a Conv ``kernel`` (k, in, out) becomes ``weight`` (out, in, k), and a
    3-D one (kt, kh, kw, in, out) becomes (out, in, kt, kh, kw) (the
    squeeze-excite 1x1x1 convs with their biases too);
  * a LayerNorm or BatchNorm ``scale`` becomes ``weight``;
  * ``batch_stats`` ``mean``/``var`` become ``running_mean``/``running_var``
    (a SubBatchNorm's ``split_mean``/``split_var`` (s, C) keep their names);
  * each LSTM cell ``OptimizedLSTMCell_k`` is packed into the port's
    ``w_ih``, ``w_hh`` and single ``bias`` (gates i, f, g, o);
  * everything else (biases, ``space_token``, ``temporal_token``,
    ``pos_embedding``) is copied as it is.

``spatial_weights_from_flax`` converts the JAX package's ``SpatialWeights``
bundle (kernels (in, out), vectors (1, D)) into the port's bundle.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from .ops.spatial_table import SpatialWeights, as_f32_tensor


def _tensor(x, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return as_f32_tensor(x).to(dtype)


_LSTM_GATES = ("i", "f", "g", "o")       # torch.lstm's packing order
_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _lstm_cell_from_flax(cell: Mapping, prefix: str) -> dict:
    """One flax ``OptimizedLSTMCell`` (``ii|if|ig|io`` input kernels (in, H),
    ``hi|hf|hg|ho`` recurrent kernels (H, H) with their biases) -> the
    port's ``w_ih`` (4H, in), ``w_hh`` (4H, H) and single ``bias`` (4H)."""
    return {
        f"{prefix}w_ih": torch.cat([_tensor(cell[f"i{g}"]["kernel"]).T
                                    for g in _LSTM_GATES]).contiguous(),
        f"{prefix}w_hh": torch.cat([_tensor(cell[f"h{g}"]["kernel"]).T
                                    for g in _LSTM_GATES]).contiguous(),
        f"{prefix}bias": torch.cat([_tensor(cell[f"h{g}"]["bias"]) for g in _LSTM_GATES]),
    }


def state_dict_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None,
                         prefix: str = "") -> dict:
    """flax ``params`` (and ``batch_stats``), nested dicts of numpy arrays,
    -> ``state_dict`` of the port module with the same structure."""
    out = {}
    for tree in (params, batch_stats or {}):
        for name, value in tree.items():
            if isinstance(value, Mapping):
                if name.startswith("OptimizedLSTMCell_"):
                    out.update(_lstm_cell_from_flax(value, f"{prefix}{name}."))
                else:
                    out.update(state_dict_from_flax(value, None, f"{prefix}{name}."))
            elif name == "kernel":
                w = _tensor(value)
                # (*kernel, in, out) -> (out, in, *kernel); a Dense's (in, out) -> (out, in)
                d = w.dim()
                out[f"{prefix}weight"] = w.permute(d - 1, d - 2, *range(d - 2)).contiguous()
            else:
                out[f"{prefix}{_RENAME.get(name, name)}"] = _tensor(value)
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

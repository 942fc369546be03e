"""Weight bridge between the JAX package's flax trees and the port, both ways.

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

``flax_from_state_dict`` is its exact inverse (a port module or its
``state_dict`` -> flax ``params`` and ``batch_stats``, keys sorted as
``jax.device_get`` leaves them). ``opt_state_from_flax`` and
``opt_state_to_flax`` carry the optimizer state between optax's chain
(``kstar_tpu/train/state.py:42-67``, as ``flax.serialization`` writes it:
tuples as ``{"0": ..., "1": ...}``, namedtuples by field name, an empty
state as ``{}``) and the port's flat ``TrainState.opt_state``.

``spatial_weights_from_flax`` converts the JAX package's ``SpatialWeights``
bundle (kernels (in, out), vectors (1, D)) into the port's bundle.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from .ops.spatial_table import SpatialWeights, as_f32_tensor


def _tensor(x, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return as_f32_tensor(x).to(dtype)


_LSTM_GATES = ("i", "f", "g", "o")       # torch.lstm's packing order
_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
_LSTM_CELL = "OptimizedLSTMCell_"
# the port's persistent statistics, flax's ``batch_stats`` (SubBatchNorm's
# split statistics keep their names)
_STATS = {"running_mean": "mean", "running_var": "var",
          "split_mean": "split_mean", "split_var": "split_var"}


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
                if name.startswith(_LSTM_CELL):
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


def _sorted_tree(tree: dict) -> dict:
    return {k: _sorted_tree(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def _put(tree: dict, path, value) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    if path[-1] in tree:
        raise ValueError(f"flax_from_state_dict: two port tensors map to {'/'.join(path)}")
    tree[path[-1]] = value


def _lstm_cell_to_flax(w_ih: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor) -> dict:
    """The inverse of ``_lstm_cell_from_flax``: input kernels without a bias,
    recurrent kernels with the cell's bias."""
    cell = {}
    for w_i, w_h, b, g in zip(w_ih.chunk(4), w_hh.chunk(4), bias.chunk(4), _LSTM_GATES):
        cell[f"i{g}"] = {"kernel": w_i.T.contiguous()}
        cell[f"h{g}"] = {"kernel": w_h.T.contiguous(), "bias": b.clone()}
    return cell


def flax_from_state_dict(module_or_state_dict) -> Tuple[dict, dict]:
    """A port module (or its ``state_dict``) -> (flax ``params``,
    ``batch_stats``), the exact inverse of ``state_dict_from_flax``: a
    ``weight`` of two or more dimensions is a kernel, permuted back to
    (*kernel, in, out); a one-dimensional ``weight`` is a norm's ``scale``;
    ``running_mean``/``running_var`` go to ``batch_stats`` as
    ``mean``/``var`` and SubBatchNorm's ``split_mean``/``split_var`` under
    their own names; an LSTM cell's ``w_ih``/``w_hh``/``bias`` are unpacked
    into ``ii..io``/``hi..ho``. Tensors are detached CPU f32 copies."""
    sd = (module_or_state_dict.state_dict()
          if isinstance(module_or_state_dict, torch.nn.Module) else module_or_state_dict)
    params: dict = {}
    stats: dict = {}
    cells: Dict[tuple, dict] = {}
    for key, value in sd.items():
        path = tuple(key.split("."))
        w = value.detach().to("cpu", torch.float32)
        cell_at = next((i for i, n in enumerate(path) if n.startswith(_LSTM_CELL)), None)
        if cell_at is not None:
            cells.setdefault(path[:cell_at + 1], {})[path[-1]] = w
        elif path[-1] in _STATS:
            _put(stats, path[:-1] + (_STATS[path[-1]],), w.clone())
        elif path[-1] == "weight" and w.dim() >= 2:
            d = w.dim()
            _put(params, path[:-1] + ("kernel",),
                 w.permute(*range(2, d), 1, 0).contiguous())
        elif path[-1] == "weight":
            _put(params, path[:-1] + ("scale",), w.clone())
        else:
            _put(params, path, w.clone())
    for path, cell in cells.items():
        if set(cell) != {"w_ih", "w_hh", "bias"}:
            raise ValueError(f"flax_from_state_dict: LSTM cell {'.'.join(path)} holds "
                             f"{sorted(cell)}, not w_ih, w_hh and bias")
        _put(params, path, _lstm_cell_to_flax(cell["w_ih"], cell["w_hh"], cell["bias"]))
    return _sorted_tree(params), _sorted_tree(stats)


# the port's moment names (``kstar_torch/train/state.py Optimizer.init``)
_MOMENTS = ("trace", "mu", "nu")


def _find_nodes(tree, found: Dict[str, list]) -> None:
    """Collect the optax state nodes that hold a moment tree or a count."""
    if not isinstance(tree, Mapping):
        return
    for name, value in tree.items():
        if name in _MOMENTS and isinstance(value, Mapping):
            found.setdefault(name, []).append(value)
        elif name == "count" and not isinstance(value, Mapping):
            found.setdefault("count", []).append(value)
        else:
            _find_nodes(value, found)


def _flat_from_named(named: dict, model: torch.nn.Module, params: list,
                     what: str) -> torch.Tensor:
    """Port-named tensors -> one flat f32 vector in ``TrainState.flat``'s
    order (``params``: the state's trainable parameters)."""
    trainable = {id(p) for p in params}
    names = [n for n, p in model.named_parameters() if id(p) in trainable]
    missing = [n for n in names if n not in named]
    extra = sorted(set(named) - set(names))
    if missing or extra:
        raise ValueError(f"opt_state_from_flax: the {what} tree does not match the model "
                         f"(first missing {missing[:1]}, first extra {extra[:1]})")
    parts = []
    for n, p in zip(names, params):
        if tuple(named[n].shape) != tuple(p.shape):
            raise ValueError(f"opt_state_from_flax: {what} {n} has shape "
                             f"{tuple(named[n].shape)}, the model {tuple(p.shape)}")
        parts.append(named[n].reshape(-1))
    return torch.cat(parts) if parts else torch.zeros(0)


def opt_state_from_flax(opt_tree: Mapping, state, step=None) -> Dict[str, torch.Tensor]:
    """optax's chain state (the ``opt_state`` of a JAX checkpoint) -> the
    port's flat optimizer state for ``state`` (a ``TrainState``), on its
    device: each moment tree the port's optimizer keeps (``trace`` | ``mu``,
    ``nu`` | ``nu``) goes through ``state_dict_from_flax`` and is flattened
    in the order of ``state.flat``. ``count`` is the chain's count of
    applied updates (``scale_by_adam``'s and ``scale_by_schedule``'s, which
    move together); a chain without one (SGD or AdamW at a constant rate
    has none) takes ``step``, the checkpoint's applied-update count."""
    found: Dict[str, list] = {}
    _find_nodes(opt_tree, found)
    out = {}
    for name in state.opt_state:
        if name == "count":
            continue
        nodes = found.get(name, [])
        if len(nodes) != 1:
            raise ValueError(f"opt_state_from_flax: the {state.tx.name} state needs one "
                             f"{name!r} tree, the checkpoint holds {len(nodes)}")
        named = state_dict_from_flax(nodes[0])
        out[name] = _flat_from_named(named, state.model, state.params, name).to(state.device)
    counts = {int(c) for c in found.get("count", [])}
    if len(counts) > 1:
        raise ValueError(f"opt_state_from_flax: the chain's counts disagree: {sorted(counts)}")
    if not counts and step is None:
        raise ValueError("opt_state_from_flax: the chain keeps no count; pass the step")
    count = counts.pop() if counts else int(step)
    out["count"] = torch.tensor(count, dtype=torch.int32, device=state.device)
    return out


def opt_state_to_flax(state) -> dict:
    """The port's optimizer state -> optax's chain state for the same
    optimizer, as ``flax.serialization`` writes it (the inverse of
    ``opt_state_from_flax``): ``chain(clip_by_global_norm?, tx)`` with
    ``sgd`` = (trace, rate), ``adam`` = (count/mu/nu, rate), ``adamw`` =
    (count/mu/nu, decay, rate), ``rmsprop`` = (nu, rate, identity); a
    scheduled rate keeps ``count``, a constant one is empty."""
    tx = state.tx
    count = state.opt_state["count"].detach().to("cpu", torch.int32).clone()

    def moment(name: str) -> dict:
        flat = state.opt_state[name].detach().to("cpu", torch.float32)
        named, offset = {}, 0
        trainable = {id(p) for p in state.params}
        for n, p in state.model.named_parameters():
            if id(p) in trainable:
                named[n] = flat[offset:offset + p.numel()].view_as(p)
                offset += p.numel()
        return flax_from_state_dict(named)[0]

    rate = {"count": count} if tx.transition_steps is not None else {}
    if tx.name == "sgd":
        inner = {"0": {"trace": moment("trace")}, "1": rate}
    elif tx.name == "adam":
        inner = {"0": {"count": count.clone(), "mu": moment("mu"), "nu": moment("nu")},
                 "1": rate}
    elif tx.name == "adamw":
        inner = {"0": {"count": count.clone(), "mu": moment("mu"), "nu": moment("nu")},
                 "1": {}, "2": rate}
    else:
        inner = {"0": {"nu": moment("nu")}, "1": rate, "2": {}}
    return {"0": {}, "1": inner} if tx.max_norm is not None else inner


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

"""Map a flax variable tree of the JAX package onto the port's state_dict.

A flax checkpoint is {"params": ..., "batch_stats": ...}, nested dicts of
arrays. The port names its submodules after the flax tree, so each leaf
maps by rule:

  module  Dense_i -> dense.i,  LayerNorm_i -> norm.i,
          CausalConv1d_0 -> conv,  Conv_0 -> conv,  BatchNorm_0 -> bn,
          any other name (skip_proj, lstm, conv_3, ...) unchanged
  leaf    kernel (in, out)      -> weight (out, in)       Dense
          kernel (k, in, out)   -> weight (out, in, k)    Conv
          scale -> weight, bias -> bias,
          mean -> running_mean, var -> running_var        BatchNorm stats
          w_ih_l, w_hh_l, bias_l unchanged                LSTM: (in, 4H)
                                                          layout, [i,f,g,o]

Every shape comes from the model, so a tree of any configuration converts
into a port model built with the same fields (latent widths, decimation
factor, LSTM sizes, channel counts). Conversion fails on any leaf without
a counterpart, any counterpart without a leaf, and any shape mismatch.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_MODULE_RULES = ((re.compile(r"^Dense_(\d+)$"), r"dense.\1"),
                 (re.compile(r"^LayerNorm_(\d+)$"), r"norm.\1"),
                 (re.compile(r"^CausalConv1d_0$"), "conv"),
                 (re.compile(r"^Conv_0$"), "conv"),
                 (re.compile(r"^BatchNorm_0$"), "bn"))
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def torch_key(path: Tuple[str, ...]) -> str:
    """The state_dict key of the flax leaf at `path` (collection excluded)."""
    parts = []
    for seg in path[:-1]:
        for pattern, repl in _MODULE_RULES:
            if pattern.match(seg):
                seg = pattern.sub(repl, seg)
                break
        parts.append(seg)
    parts.append(_LEAF_NAMES.get(path[-1], path[-1]))
    return ".".join(parts)


def to_torch_layout(leaf_name: str, array: np.ndarray) -> np.ndarray:
    """A flax kernel in PyTorch's layout; any other leaf unchanged."""
    if leaf_name == "kernel" and array.ndim == 2:
        return array.T
    if leaf_name == "kernel" and array.ndim == 3:
        return array.transpose(2, 1, 0)
    return array


def flax_to_state_dict(variables: Mapping, model: nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """The state_dict for `model` holding the flax `variables`."""
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unmatched = []
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            key = torch_key(path)
            if key not in expected or key in out:
                unmatched.append("/".join((collection,) + path))
                continue
            value = torch.tensor(np.ascontiguousarray(
                to_torch_layout(path[-1], np.asarray(leaf, np.float32))))
            if value.shape != expected[key].shape:
                raise ValueError(f"{'/'.join(path)}: shape {tuple(value.shape)}"
                                 f" does not fit {key} "
                                 f"{tuple(expected[key].shape)}")
            out[key] = value.to(expected[key].dtype)
    missing = sorted(set(expected) - set(out))
    if unmatched or missing:
        raise KeyError(f"flax tree and model disagree: unmatched flax leaves "
                       f"{unmatched}, model entries without a leaf {missing}")
    return out


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy flax `variables` into `model` in place; returns the model."""
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    return model

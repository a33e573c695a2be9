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
          attention/{query,key,value,out}/kernel          flax DenseGeneral:
                                                          unchanged
                                                          (C, heads, head_dim)
                                                          and (heads,
                                                          head_dim, C)

The attention kernels are 3-D like a conv kernel: `to_torch_layout`
tells them apart by their path.

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


_INVERSE_MODULES = ((re.compile(r"^dense\.(\d+)$"), r"Dense_\1"),
                    (re.compile(r"^norm\.(\d+)$"), r"LayerNorm_\1"),
                    (re.compile(r"^bn$"), "BatchNorm_0"))
_INVERSE_LEAVES = {"running_mean": "mean", "running_var": "var",
                   "bias": "bias"}


def flax_path(key: str, ndim: int) -> Tuple[str, ...]:
    """The flax path (collection excluded) of the state_dict entry `key`
    holding an array of `ndim` dims: `torch_key`'s inverse. A "conv"
    segment is CausalConv1d_0 when another "conv" follows it (the causal
    block's wrapper), else Conv_0; "weight" is a kernel when 2-D or more,
    else a norm's scale."""
    segs = key.split(".")
    parts = []
    i = 0
    while i < len(segs) - 1:
        seg = segs[i]
        pair = ".".join(segs[i:i + 2])
        for pattern, repl in _INVERSE_MODULES:
            if pattern.match(pair) and i + 2 < len(segs):
                parts.append(pattern.sub(repl, pair))
                i += 2
                break
            if pattern.match(seg):
                parts.append(pattern.sub(repl, seg))
                i += 1
                break
        else:
            if seg == "conv":
                parts.append("CausalConv1d_0" if segs[i + 1] == "conv"
                             else "Conv_0")
            else:
                parts.append(seg)
            i += 1
    leaf = segs[-1]
    if leaf == "weight":
        leaf = "kernel" if ndim >= 2 else "scale"
    parts.append(_INVERSE_LEAVES.get(leaf, leaf))
    return tuple(parts)


_DENSE_GENERAL = ("query", "key", "value", "out")


def to_torch_layout(leaf_name: str, array: np.ndarray,
                    path: Tuple[str, ...] = ()) -> np.ndarray:
    """A flax kernel in PyTorch's layout; any other leaf unchanged. `path`
    (the leaf's, collection excluded) marks the self-attention's
    DenseGeneral kernels (.../attention/{query,key,value,out}/kernel),
    which the port keeps in flax's layout."""
    if (len(path) >= 3 and path[-3] == "attention"
            and path[-2] in _DENSE_GENERAL):
        return array
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
                to_torch_layout(path[-1], np.asarray(leaf, np.float32),
                                path)))
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

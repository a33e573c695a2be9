"""Parameter visualizers over a model's parameters.

Port of `vae_teb_tpu.utils.visualize`: a heatmap for kernels of two or more
dims, a histogram for 1-D leaves, and an RMS overview of every leaf, saved
to files. They take a module or a state_dict and address each parameter by
its JAX tree path ('decoder/output_mu/Dense_0/kernel', through
`convert.flax_path`), with kernels shown in flax's layout. matplotlib is
imported inside the functions (a machine without it can import this
module).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from ..convert import flax_path, to_torch_layout

_BUFFERS = ("running_mean", "running_var")


def _flatten(params: Union[nn.Module, Mapping[str, torch.Tensor]]
             ) -> Dict[str, np.ndarray]:
    """{JAX tree path: array in flax's layout} of the parameters (a
    module's, or a state_dict's entries other than BatchNorm statistics)."""
    if isinstance(params, nn.Module):
        items = params.named_parameters()
    else:
        items = ((k, v) for k, v in params.items()
                 if k.rsplit(".", 1)[-1] not in _BUFFERS)
    out = {}
    for key, t in items:
        arr = torch.as_tensor(t).detach().float().cpu().numpy()
        path = flax_path(key, arr.ndim)
        # to_torch_layout swaps a kernel's axes, so it is its own inverse
        out["/".join(path)] = np.asarray(to_torch_layout(path[-1], arr, path))
    return out


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def list_layers(params) -> List[str]:
    """All parameter paths, e.g. 'decoder/output_mu/Dense_0/kernel'."""
    return sorted(_flatten(params))


def visualize_layer_parameters(params, layer_path: str, save_path: str,
                               cmap: str = "viridis") -> None:
    """Heatmap (>= 2-D, flattened to 2-D) or histogram (1-D) of one
    parameter. layer_path: an exact path or a unique suffix of one."""
    flat = _flatten(params)
    if layer_path in flat:
        key = layer_path
    else:
        matches = [k for k in flat if k.endswith(layer_path)]
        if len(matches) != 1:
            raise ValueError(
                f"layer {layer_path!r} matches {len(matches)} parameters"
                + (f": {matches[:5]}" if matches else ""))
        key = matches[0]
    param = flat[key]
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 4.5), constrained_layout=True)
    if param.ndim >= 2:
        im = ax.imshow(param.reshape(param.shape[0], -1), cmap=cmap,
                       aspect="auto")
        fig.colorbar(im, ax=ax)
        ax.set_xlabel("features")
        ax.set_ylabel("units")
    else:
        ax.hist(param.ravel(), bins=50)
        ax.set_xlabel("value")
    ax.set_title(key)
    fig.savefig(save_path, dpi=110)
    plt.close(fig)


def visualize_weight_overview(params, save_path: str,
                              top_k: Optional[int] = 40) -> None:
    """Every parameter's RMS magnitude (log scale), ranked, in one figure:
    dead or exploding layers stand out."""
    flat = _flatten(params)
    rms_of = {k: float(np.sqrt(np.mean(v.astype(np.float64) ** 2)))
              for k, v in flat.items()}
    names = sorted(flat, key=lambda k: -rms_of[k])
    if top_k:
        names = names[:top_k]
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 0.28 * len(names) + 1.5),
                           constrained_layout=True)
    ax.barh(range(len(names)), [rms_of[k] for k in names])
    ax.set_yticks(range(len(names)))
    ax.set_yticklabels([n if len(n) < 60 else "..." + n[-57:]
                        for n in names], fontsize=6)
    ax.invert_yaxis()
    ax.set_xscale("log")
    ax.set_xlabel("parameter RMS")
    fig.savefig(save_path, dpi=110)
    plt.close(fig)

"""Weights carried across from the reference package.

The one place that knows both layouts: the reference keeps ``x @ W`` with
``W`` shaped ``[in, out]`` and stacks the layers' weights as ``[L, ...]``;
the port keeps PyTorch's ``[out, in]`` and one dict per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import torch_dtype

_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w_gate", "w_up", "w_down")


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The reference's ``init_params`` tree, already converted to numpy
    arrays, as the port's parameters on ``device`` in ``cfg.dtype``."""
    dt = torch_dtype(cfg.dtype)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), dtype=dt,
                            device=device)

    def linear(a):                      # [in, out] -> [out, in]
        return t(np.swapaxes(a, -1, -2))

    emb = tree["embed"]
    p = {"embed": {"embed": t(emb["embed"])}}
    if "lm_head" in emb:
        p["embed"]["lm_head"] = linear(emb["lm_head"])
    lay = tree["layers"]
    p["layers"] = [{
        "ln1": t(lay["ln1"][i]), "ln2": t(lay["ln2"][i]),
        "attn": {k: linear(lay["attn"][k][i]) for k in _ATTN},
        "mlp": {k: linear(lay["mlp"][k][i]) for k in _MLP},
    } for i in range(cfg.num_layers)]
    p["final_norm"] = t(tree["final_norm"])
    return p

"""Weights and decode caches carried across from the reference package.

The one place that knows both layouts: the reference keeps ``x @ W`` with
``W`` shaped ``[in, out]`` and stacks the layers' weights as ``[L, ...]``;
the port keeps PyTorch's ``[out, in]`` and one dict per layer, except in
the MoE block, whose leaves keep the reference's layout (``models.moe``).
RWKV6 vectors (``mu_*``, ``decay_base``, ``bonus_u``, norm scales) and
the qk-norm scales ``q_norm``/``k_norm`` keep their shapes, as do MLA's
norm scales ``q_ln``/``kv_ln``; its projections (``w_dq``, ``w_uq``,
``w_dkv``, ``w_kr``, ``w_uk``, ``w_uv``, ``wo``) turn like any other.
Leaves the reference keeps in fp32 (the MoE router, ``decay_base``,
``bonus_u``) stay fp32. An encdec tree's ``encoder`` and ``cross`` stacks become per-layer
dicts (the cross-attention one inside each decoder layer); an encdec or
vlm tree's ``frontend_proj`` is a projection like any other. A hybrid
tree's stacked ``mamba`` and ``mamba_tail`` become per-layer dicts
(``w_in``/``w_out`` turn, the conv and the fp32 ``A_log``, ``dt_bias``,
``D`` keep their shapes); its shared block turns like a layer, and the
LoRA stacks ``lora_a``/``lora_b`` keep their group axis and layout.
Caches keep the reference's layout, but for the paged pools' trash page,
``enc_kv`` (a (k, v) pair there and a ``{"k", "v"}`` dict here) and the
hybrid's state (its ``body`` and ``tail`` stacks there, one stack of every
layer here, the body's first).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2 as M2
from repro_torch.models.rwkv6 import FP32_LEAVES, MATRICES
from repro_torch.models.transformer import torch_dtype

_ATTN = ("wq", "wk", "wv", "wo")
_QK_NORM = ("q_norm", "k_norm")
_MLA = ("w_dq", "w_uq", "w_dkv", "w_kr", "w_uk", "w_uv", "wo")
_MLA_NORM = ("q_ln", "kv_ln")
_MLP = ("w_gate", "w_up", "w_down")


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The reference's ``init_params`` tree, already converted to numpy
    arrays, as the port's parameters on ``device`` in ``cfg.dtype``."""
    dt = torch_dtype(cfg.dtype)

    def t(a, dtype=dt):
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=device)

    def linear(a):                      # [in, out] -> [out, in]
        return t(np.swapaxes(a, -1, -2))

    emb = tree["embed"]
    p = {"embed": {"embed": t(emb["embed"])}}
    if "lm_head" in emb:
        p["embed"]["lm_head"] = linear(emb["lm_head"])
    p["final_norm"] = t(tree["final_norm"])
    if cfg.family == "hybrid":
        def mamba(stack):
            n = len(next(iter(stack.values())))
            return [{k: (linear(a[i]) if k in M2.MATRICES else
                         t(a[i], torch.float32) if k in M2.FP32_LEAVES
                         else t(a[i])) for k, a in stack.items()}
                    for i in range(n)]

        sh = tree["shared"]
        p["mamba"] = mamba(tree["mamba"])
        if "mamba_tail" in tree:
            p["mamba_tail"] = mamba(tree["mamba_tail"])
        p["shared"] = {
            "ln1": t(sh["ln1"]), "ln2": t(sh["ln2"]),
            "attn": {k: linear(sh["attn"][k]) for k in _ATTN},
            "mlp": {k: linear(sh["mlp"][k]) for k in _MLP},
            "lora_a": t(sh["lora_a"]), "lora_b": t(sh["lora_b"])}
        return p
    lay = tree["layers"]
    if cfg.family == "ssm":
        p["layers"] = [{
            k: (linear(a[i]) if k in MATRICES else
                t(a[i], torch.float32) if k in FP32_LEAVES else t(a[i]))
            for k, a in lay.items()} for i in range(cfg.num_layers)]
        return p

    def moe(m, i):                      # the reference's layout, per layer
        out = {k: t(m[k][i], torch.float32 if k == "router" else dt)
               for k in ("router", *_MLP)}
        if "shared" in m:
            out["shared"] = {k: t(m["shared"][k][i]) for k in _MLP}
        return out

    def attn(a, i):
        if cfg.use_mla:
            out = {k: linear(a[k][i]) for k in _MLA}
            out.update({k: t(a[k][i]) for k in _MLA_NORM})
            return out
        out = {k: linear(a[k][i]) for k in _ATTN}
        out.update({k: t(a[k][i]) for k in _QK_NORM if k in a})
        return out

    def layer(stack, i):
        out = {"ln1": t(stack["ln1"][i]), "ln2": t(stack["ln2"][i]),
               "attn": attn(stack["attn"], i)}
        if "moe" in stack:
            out["moe"] = moe(stack["moe"], i)
        else:
            out["mlp"] = {k: linear(stack["mlp"][k][i]) for k in _MLP}
        return out

    p["layers"] = [layer(lay, i) for i in range(cfg.num_layers)]
    if cfg.family == "encdec":
        enc, cross = tree["encoder"], tree["cross"]
        for i, lp in enumerate(p["layers"]):
            lp["cross"] = {"ln": t(cross["ln"][i]),
                           "attn": attn(cross["attn"], i)}
        p["encoder"] = {"layers": [layer(enc, i)
                                   for i in range(cfg.encoder_layers)],
                        "final_norm": t(enc["final_norm"])}
    if "frontend_proj" in tree:          # encdec frames, vlm patches
        p["frontend_proj"] = linear(tree["frontend_proj"])
    return p


def cache_from_numpy(tree: dict, device) -> dict:
    """The reference's decode cache, already converted to numpy arrays, in
    the port's layout on ``device``: dense, int8 (``k_scale``/``v_scale``),
    paged (``table``), an MLA model's latents (``ckv``/``kr``) or an ssm
    family's recurrent ``state``, a hybrid's ``state`` and ``attn``, and
    an encdec cache's ``enc_kv``. The leaves keep their shapes and
    dtypes, except that each paged pool gains the trash page (zeros)
    after its P pages, whose id P is the reference's sentinel, and that
    a hybrid's ``body`` and ``tail`` states join along the layer axis;
    the ``span`` marker is dropped."""
    paged = "table" in tree

    def t(a, pool=paged):
        a = np.asarray(a)
        if pool:                       # [L, P, page, ...] -> [L, P+1, ...]
            a = np.concatenate([a, np.zeros_like(a[:, :1])], axis=1)
        if a.dtype.name == "bfloat16":      # numpy has no bf16 of its own
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.tensor(a, device=device)   # a copy: caches are written

    pos = torch.tensor(np.asarray(tree["pos"], np.int32), device=device)
    if "attn" in tree:                  # hybrid: body + tail, one stack
        st = tree["state"]
        return {"state": {n: t(np.concatenate(
                    [st[part][n] for part in ("body", "tail") if part in st]))
                    for n in st["body"]},
                "attn": {n: t(a) for n, a in tree["attn"].items()},
                "pos": pos}
    part = "state" if "state" in tree else "kv"
    out = {part: {name: t(leaf) for name, leaf in tree[part].items()},
           "pos": pos}
    if paged:
        out["table"] = torch.tensor(np.asarray(tree["table"], np.int32),
                                    device=device)
    if "enc_kv" in tree:
        out["enc_kv"] = {n: t(a, pool=False)
                         for n, a in zip(("k", "v"), tree["enc_kv"])}
    return out

"""Models: parameters, the training loss, prefill, extend and decode.

Port of the ``"dense"`` (with or without qk-norm), ``"moe"`` (GQA or MLA
attention), ``"ssm"`` (RWKV6), ``"hybrid"`` (zamba2), ``"encdec"`` and
``"vlm"`` families of ``repro/models/transformer.py``. The
layer stack is a Python loop over a list of per-layer parameter dicts (the
reference scans a stacked ``[L, ...]`` tree). Parameters live on the
device of the ``torch.Generator`` that draws them. A moe layer has
``"moe"`` (``models.moe``) in place of ``"mlp"``; an MLA model's ``"attn"``
holds ``models.mla``'s weights; an ssm layer is an RWKV6 block
(``models.rwkv6``). An encdec model adds ``"encoder"`` (its own
layers, bidirectional, and a final norm), ``"frontend_proj"`` [d, d] (the
audio frontend stub's projection of the ``frames`` input) and, in each
decoder layer, ``"cross"`` (a norm and an attention block over the
encoder's output). A vlm model adds ``"frontend_proj"`` [d, d], the vision
frontend stub's projection of the ``patches`` input, which its prefill
puts before the text as a bidirectional prefix: the cache then holds the
patches' K/V ahead of the prompt's, and ``pos`` counts them.

Cache layouts, as in the reference: dense ``{"kv": {"k": [L,B,S,KVH,hd],
"v": ...}, "pos": [B] int32}``; int8 adds ``"k_scale"``/``"v_scale"``
[L,B,S,KVH] fp32 beside int8 ``k``/``v``; paged keeps page pools
``[L,P+1,page,KVH,...]`` (the last page is the trash page, see
``layers.paged_view``) and a block table ``"table"`` [B,W] int32. The
reference's ``span`` leaf (the logical ``max_seq``, used there to pad the
softmax sum to the dense width) has no counterpart: paged and dense agree
to rounding here, not bit for bit. The ssm family's cache is its recurrent
state, ``{"state": {"wkv": [L,B,H,hd,hd], "tm": [L,B,D], "cm": [L,B,D]}
(fp32), "pos": [B]}``, with no sequence axis. An encdec cache adds
``"enc_kv": {"k", "v"}`` [L,B,Se,KVH,hd], the cross-attention's K/V of
the encoder output, dense per row in every layout and never quantized
(the reference keeps it as a (k, v) pair). An MLA cache's ``kv`` holds the
latents instead, ``{"ckv": [L,B,S,kv_lora], "kr": [L,B,S,rope]}``, dense
in every layout and never quantized. ``extend_fn`` and
``decode_fn`` update the cache in place and return it.

The hybrid (zamba2) runs ``groups`` groups of (one shared attention + MLP
block, with the group's LoRA delta on q/k/v, then ``per`` Mamba2 layers),
then ``tail`` Mamba2 layers (``_zamba_grouping``). Its parameters:
``"mamba"`` (groups x per layer dicts, ``models.mamba2``),
``"mamba_tail"`` (tail of them, when tail > 0) and ``"shared"``: ``ln1``,
``attn``, ``ln2``, ``mlp`` and the LoRA stacks ``lora_a`` [groups, d, r]
and ``lora_b`` [groups, r, 3d], which keep the reference's ``x @ W``
layout (``lora_b`` zero-initialised, as there). Its cache is
``{"state": {"ssm": [L,B,H,P,N], "conv": [L,B,W-1,d_in+2N]} (fp32, the
body's layers first, then the tail), "attn": {"k", "v"}
[groups,B,S,KVH,hd] (int8 with scales as above), "pos"}``; it has no paged
layout.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import WKV6_CHUNK
from repro_torch.models import layers as Lyr
from repro_torch.models import mamba2 as M2
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as RWKV


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(name)]


def _dense(gen, out_f: int, in_f: int, dtype):
    """A projection in the ``[out, in]`` layout, normal / sqrt(in_f)."""
    return Lyr.dense_init(gen, (out_f, in_f), in_f, dtype)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random weights from ``gen``, on ``gen.device``: norms are ones,
    projections normal / sqrt(fan_in)."""
    dt = torch_dtype(cfg.dtype)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    ones = lambda n=d: torch.ones((n,), dtype=dt, device=gen.device)
    p = {"embed": {"embed": _dense(gen, cfg.vocab_size, d, dt)}}
    if not cfg.tie_embeddings:
        p["embed"]["lm_head"] = _dense(gen, cfg.vocab_size, d, dt)
    if cfg.family == "ssm":
        p["layers"] = [RWKV.rwkv6_params(cfg, gen, dt)
                       for _ in range(cfg.num_layers)]
        p["final_norm"] = ones()
        return p

    def attn():
        a = {"wq": _dense(gen, H * hd, d, dt),
             "wk": _dense(gen, KVH * hd, d, dt),
             "wv": _dense(gen, KVH * hd, d, dt),
             "wo": _dense(gen, d, H * hd, dt)}
        if cfg.qk_norm:
            a["q_norm"], a["k_norm"] = ones(hd), ones(hd)
        return a

    def mlp():
        return {"w_gate": _dense(gen, f, d, dt), "w_up": _dense(gen, f, d, dt),
                "w_down": _dense(gen, d, f, dt)}

    if cfg.family == "hybrid":
        groups, per, tail = _zamba_grouping(cfg)
        p["mamba"] = [M2.mamba2_params(cfg, gen, dt)
                      for _ in range(groups * per)]
        if tail:
            p["mamba_tail"] = [M2.mamba2_params(cfg, gen, dt)
                               for _ in range(tail)]
        r = cfg.shared_attn_lora_rank
        p["shared"] = {
            "ln1": ones(), "attn": attn(), "ln2": ones(), "mlp": mlp(),
            "lora_a": Lyr.dense_init(gen, (groups, d, r), d, dt),
            "lora_b": torch.zeros((groups, r, 3 * d), dtype=dt,
                                  device=gen.device)}
        p["final_norm"] = ones()
        return p

    layers = []
    for _ in range(cfg.num_layers):
        layer = {"ln1": ones(), "ln2": ones(),
                 "attn": MLA.mla_params(cfg, gen, dt) if cfg.use_mla
                 else attn()}
        if cfg.is_moe:
            layer["moe"] = MOE.moe_params(cfg, gen, dt)
        else:
            layer["mlp"] = mlp()
        if cfg.family == "encdec":
            layer["cross"] = {"ln": ones(), "attn": attn()}
        layers.append(layer)
    p["layers"] = layers
    p["final_norm"] = ones()
    if cfg.family == "encdec":
        p["encoder"] = {
            "layers": [{"ln1": ones(), "ln2": ones(), "attn": attn(),
                        "mlp": mlp()} for _ in range(cfg.encoder_layers)],
            "final_norm": ones()}
        p["frontend_proj"] = _dense(gen, d, d, dt)
    if cfg.family == "vlm":
        p["frontend_proj"] = _dense(gen, d, d, dt)
    return p


def _device(params) -> torch.device:
    return params["final_norm"].device


def _layer(cfg, p, x, positions, *, mode="prefill", causal=True,
           prefix_len=0, cache=None, pos=None, rows=None, table=None,
           enc=None, reference=False):
    """One layer: self-attention (its first ``prefix_len`` keys seen by
    every query in prefill; MLA's latent attention for an MLA model), then
    (an encdec decoder layer, ``enc`` = (k, v, lengths) of its ``enc_kv``)
    cross-attention, then the MLP or the MoE block. Returns (x, the
    layer's K/V, the MoE block's router aux loss or None): training adds
    the aux to its loss, serving drops it."""
    h = Lyr.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        o, kv = MLA.mla_block(cfg, p["attn"], h, positions=positions,
                              mode=mode, cache=cache, pos=pos, rows=rows,
                              reference=reference)
    else:
        o, kv = Lyr.attention_block(cfg, p["attn"], h, positions=positions,
                                    mode=mode, causal=causal,
                                    prefix_len=prefix_len, cache=cache,
                                    pos=pos, rows=rows, table=table,
                                    reference=reference)
    x = x + o
    if "cross" in p:
        h = Lyr.rmsnorm(p["cross"]["ln"], x, cfg.norm_eps)
        k, v, enc_len = enc
        x = x + Lyr.cross_attention(cfg, p["cross"]["attn"], h, k, v,
                                    mode=mode, enc_len=enc_len,
                                    reference=reference)
    h = Lyr.rmsnorm(p["ln2"], x, cfg.norm_eps)
    aux = None
    if "moe" in p:
        o, aux = MOE.moe_block(cfg, p["moe"], h, reference=reference)
    else:
        o = Lyr.mlp(p["mlp"], h)
    return x + o, kv, aux


def _rwkv_forward(cfg, params, x, state: dict, *, rows=None, **scan):
    """The RWKV6 layers from ``state`` (leaves [L, B, ...]); each layer's
    new state is written into it in place, for the rows ``rows`` [B] bool
    selects (default all): the others keep theirs bit for bit. ``scan``:
    ``rwkv6.time_mix``'s keywords (``step`` for a decode step)."""
    for i, p in enumerate(params["layers"]):
        x, new = RWKV.rwkv6_block(cfg, p, x, _layer_cache(state, i), **scan)
        _store_state(state, i, new, rows)
    return x


def _store_state(state: dict, i: int, new: dict, rows=None) -> None:
    """Layer ``i``'s new recurrent state into ``state`` (leaves [L, B,
    ...]) in place, for the rows ``rows`` [B] bool selects (default all);
    the others keep theirs bit for bit."""
    for name, leaf in state.items():
        if rows is None:
            leaf[i] = new[name]
        else:
            keep = rows.view(-1, *([1] * (leaf.dim() - 2)))
            leaf[i] = torch.where(keep, new[name], leaf[i])


def _zamba_grouping(cfg) -> tuple[int, int, int]:
    """(groups, Mamba2 layers per group, tail layers) of the hybrid."""
    per = cfg.shared_attn_every
    groups = cfg.num_layers // per
    return groups, per, cfg.num_layers - groups * per


def _hybrid_forward(cfg, params, x, positions, state: Optional[dict], *,
                    mode="prefill", attn=None, pos=None, rows=None,
                    reference=False):
    """The hybrid's groups, then its tail. Each group: the shared
    attention over the group's ``attn`` leaves (``attn[name][g]``; in
    prefill ``attn`` gets each group's fresh (k, v) written in, unless it
    is None), with the group's LoRA delta on q/k/v, and the shared MLP;
    then the group's Mamba2 layers. ``state`` (leaves [L, B, ...]) takes
    each layer's new state in place (``_store_state``). Training passes
    ``state=None`` and ``attn=None``: each Mamba2 layer starts from a zero
    state of its own and drops its new one, and no K/V is kept, so
    nothing that autograd saves is written in place."""
    groups, per, _tail = _zamba_grouping(cfg)
    sh = params["shared"]
    zero = None
    if state is None:
        zero = _layer_cache(M2.mamba2_state_init(cfg, x.shape[0], 1,
                                                 x.device), 0)

    def mamba(i, p, x):
        if zero is not None:
            return M2.mamba2_block(cfg, p, x, zero)[0]
        x, new = M2.mamba2_block(cfg, p, x, _layer_cache(state, i))
        _store_state(state, i, new, rows)
        return x

    for g in range(groups):
        h = Lyr.rmsnorm(sh["ln1"], x, cfg.norm_eps)
        delta = (h @ sh["lora_a"][g]) @ sh["lora_b"][g]
        o, kv = Lyr.attention_block(
            cfg, sh["attn"], h, positions=positions, mode=mode,
            cache=None if mode == "prefill" else _layer_cache(attn, g),
            pos=pos, rows=rows, reference=reference,
            qkv_delta=delta.chunk(3, dim=-1))
        if kv is not None and attn is not None:
            for leaf, t in zip(attn.values(), kv):
                leaf[g] = t
        x = x + o
        h = Lyr.rmsnorm(sh["ln2"], x, cfg.norm_eps)
        x = x + Lyr.mlp(sh["mlp"], h)
        for j in range(per):
            x = mamba(g * per + j, params["mamba"][g * per + j], x)
    for j, p in enumerate(params.get("mamba_tail", [])):
        x = mamba(groups * per + j, p, x)
    return x


def hybrid_state_init(cfg, batch: int, device) -> dict:
    """The hybrid's zeroed Mamba2 state, every layer's (the body's first,
    then the tail's) [L, batch, ...]."""
    return M2.mamba2_state_init(cfg, batch, cfg.num_layers, device)


def _encode(cfg, params, frames, reference):
    """The encoder over the frontend stub's ``frames`` [B,Se,d]: its
    bidirectional layers (no RoPE) and final norm, then every decoder
    layer's cross-attention K/V of the output, ``{"k", "v"}``
    [L,B,Se,KVH,hd]."""
    dev, dt = _device(params), params["frontend_proj"].dtype
    x = F.linear(torch.as_tensor(frames, device=dev).to(dt),
                 params["frontend_proj"])
    positions = torch.arange(x.shape[1], device=dev)
    for p in params["encoder"]["layers"]:
        x, _, _ = _layer(cfg, p, x, positions, causal=False,
                         reference=reference)
    x = Lyr.rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)
    B, Se = x.shape[:2]
    shape = (B, Se, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {n: torch.stack([F.linear(x, p["cross"]["attn"][w]).view(shape)
                            for p in params["layers"]])
            for n, w in (("k", "wk"), ("v", "wv"))}


def _enc_layer(cache: dict, i: int, enc_len=None):
    """Layer ``i``'s (k, v, lengths) of an encdec cache's ``enc_kv``, or
    None for the other families."""
    enc = cache.get("enc_kv")
    return None if enc is None else (enc["k"][i], enc["v"][i], enc_len)


def _head(cfg, params, x):
    """Last-token logits [B, V]."""
    x = Lyr.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return Lyr.logits(params["embed"], x, cfg)[:, 0]


def _patch_prefix(params, patches, x):
    """A vlm model's ``patches`` [B,P,d] projected by ``frontend_proj``,
    in ``x``'s dtype, ahead of the embedded tokens ``x`` [B,S,d]: returns
    ([B,P+S,d], P)."""
    proj = params["frontend_proj"]
    patches = F.linear(torch.as_tensor(patches, device=proj.device)
                       .to(proj.dtype), proj)
    return torch.cat([patches.to(x.dtype), x], dim=1), patches.shape[1]


def prefill_fn(cfg: ModelConfig, params, inputs: dict, *,
               reference: bool = False, wkv_chunk: int = WKV6_CHUNK):
    """Run the whole prompt [B, S]; return (last-token logits, a cache of
    exactly S positions with ``pos == S``). An encdec model also takes
    ``inputs["frames"]`` [B,Se,d] and returns their ``enc_kv``; a vlm
    model takes ``inputs["patches"]`` [B,P,d], runs them as a
    bidirectional prefix before the prompt, and returns a cache of P + S
    positions with ``pos == P + S``; an MLA model's cache holds its
    latents ``ckv``/``kr``. ``wkv_chunk``: the ssm plain path's chunk
    (``reference``)."""
    dev = _device(params)
    tokens = torch.as_tensor(inputs["tokens"], device=dev)
    B, S = tokens.shape
    x = Lyr.embed(params["embed"], tokens, cfg)
    if cfg.family == "ssm":
        pos = torch.full((B,), S, dtype=torch.int32, device=dev)
        state = RWKV.rwkv6_state_init(cfg, B, dev)
        x = _rwkv_forward(cfg, params, x, state, reference=reference,
                          wkv_chunk=wkv_chunk)
        return _head(cfg, params, x), {"state": state, "pos": pos}
    if cfg.family == "hybrid":
        pos = torch.full((B,), S, dtype=torch.int32, device=dev)
        state = hybrid_state_init(cfg, B, dev)
        attn = {name: torch.empty((_zamba_grouping(cfg)[0], B, S, *shape),
                                  dtype=x.dtype, device=dev)
                for name, shape in _kv_shapes(cfg).items()}
        x = _hybrid_forward(cfg, params, x, torch.arange(S, device=dev),
                            state, attn=attn, reference=reference)
        return _head(cfg, params, x), {"state": state, "attn": attn,
                                       "pos": pos}
    prefix_len = 0
    if cfg.family == "vlm":
        x, prefix_len = _patch_prefix(params, inputs["patches"], x)
        S = x.shape[1]
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    positions = torch.arange(S, device=dev)
    kv_all = {name: torch.empty((cfg.num_layers, B, S, *shape),
                                dtype=x.dtype, device=dev)
              for name, shape in _kv_shapes(cfg).items()}
    cache = {"kv": kv_all, "pos": pos}
    if cfg.family == "encdec":
        cache["enc_kv"] = _encode(cfg, params, inputs["frames"], reference)
    for i, p in enumerate(params["layers"]):
        x, kv, _ = _layer(cfg, p, x, positions, prefix_len=prefix_len,
                          enc=_enc_layer(cache, i), reference=reference)
        for leaf, t in zip(kv_all.values(), kv):
            leaf[i] = t
    return _head(cfg, params, x), cache


def loss_fn(cfg: ModelConfig, params, batch: dict, *,
            reference: bool = False):
    """Next-token cross-entropy of ``batch["tokens"]`` [B, S] against
    ``batch["labels"]`` [B, S] (masked by ``batch["loss_mask"]`` if
    given): embed, every layer as in prefill (its K/V or new state not
    kept), the final norm, the logits; a moe model adds 0.01 times the
    sum of its layers' router aux losses, as the reference. An encdec
    model encodes ``batch["frames"]`` [B,Se,d] first and its decoder
    layers attend their cross K/V of it; an ssm model runs each RWKV6
    layer from a zero state of its own, and a hybrid model its groups
    (the shared attention, with the group's LoRA delta, and MLP, then the
    group's Mamba2 layers) and its tail as in prefill, each Mamba2 layer
    from a zero state of its own. Attention goes through
    ``ops.flash_attention``, the expert GEMMs through
    ``ops.expert_matmul`` and the WKV6 scan through ``ops.wkv6``, which
    autograd differentiates on the CPU and which run kernels 1, 6 and 7
    and their backward kernels on the card. A vlm model projects
    ``batch["patches"]`` [B,P,d] by ``frontend_proj`` ahead of the
    embedded tokens, runs every layer with them as a bidirectional prefix
    (``prefix_len=P``: kernel 1 at hd 256 and its backward on the card),
    and drops them again after the final norm, before the logits.
    ``reference=True`` runs the plain versions on any device. The moe
    family's MLA is not ported here: its attention (q/k 192 over v 128)
    is one kernel 1's backward does not take."""
    if cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: the moe family's MLA training is not ported yet "
            "(it waits for kernel 1's backward at q/k 192 over v 128)")
    dev = _device(params)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = Lyr.embed(params["embed"], tokens, cfg)
    prefix_len = 0
    if cfg.family == "vlm":
        x, prefix_len = _patch_prefix(params, batch["patches"], x)
    positions = torch.arange(x.shape[1], device=dev)
    auxes = []
    if cfg.family == "ssm":
        state = RWKV.rwkv6_state_init(cfg, tokens.shape[0], dev)
        for i, p in enumerate(params["layers"]):
            x, _ = RWKV.rwkv6_block(cfg, p, x, _layer_cache(state, i),
                                    reference=reference)
    elif cfg.family == "hybrid":
        x = _hybrid_forward(cfg, params, x, positions, None,
                            reference=reference)
    else:
        cache = ({"enc_kv": _encode(cfg, params, batch["frames"], reference)}
                 if cfg.family == "encdec" else {})
        for i, p in enumerate(params["layers"]):
            x, _, aux = _layer(cfg, p, x, positions, prefix_len=prefix_len,
                               enc=_enc_layer(cache, i), reference=reference)
            if aux is not None:
                auxes.append(aux)
    x = Lyr.rmsnorm(params["final_norm"], x, cfg.norm_eps)[:, prefix_len:]
    mask = batch.get("loss_mask")
    loss = Lyr.cross_entropy(
        Lyr.logits(params["embed"], x, cfg),
        torch.as_tensor(batch["labels"], device=dev),
        None if mask is None else torch.as_tensor(mask, device=dev))
    if auxes:
        loss = loss + 0.01 * torch.stack(auxes).sum()
    return loss


def _layer_cache(kv: dict, i: int) -> dict:
    """Layer ``i``'s leaves of a stacked cache (views, written in place)."""
    return {name: leaf[i] for name, leaf in kv.items()}


def extend_fn(cfg: ModelConfig, params, inputs: dict, cache: dict, *,
              rows=None, reference: bool = False,
              wkv_chunk: int = WKV6_CHUNK):
    """Continue a prefill from a decode cache (dense, int8, paged, or the
    ssm family's state) with a [B, C] chunk at each row's offset
    ``cache["pos"]``. ``rows`` [B] bool (default all) picks the rows whose
    cache and ``pos`` move; the others are left as they were, bit for bit
    (their logits are not meaningful). Returns
    (last-token logits [B, V], the cache, updated in place).
    """
    dev = _device(params)
    tokens = torch.as_tensor(inputs["tokens"], device=dev)
    B, C = tokens.shape
    pos = cache["pos"]
    x = Lyr.embed(params["embed"], tokens, cfg)
    if cfg.family == "ssm":
        x = _rwkv_forward(cfg, params, x, cache["state"], rows=rows,
                          reference=reference, wkv_chunk=wkv_chunk)
    elif cfg.family == "hybrid":
        positions = pos[:, None] + torch.arange(C, device=dev)[None, :]
        x = _hybrid_forward(cfg, params, x, positions, cache["state"],
                            mode="extend", attn=cache["attn"], pos=pos,
                            rows=rows, reference=reference)
    else:
        positions = pos[:, None] + torch.arange(C, device=dev)[None, :]
        kv, table = cache["kv"], cache.get("table")
        for i, p in enumerate(params["layers"]):
            x, _, _ = _layer(cfg, p, x, positions, mode="extend",
                             cache=_layer_cache(kv, i), pos=pos, rows=rows,
                             table=table, enc=_enc_layer(cache, i),
                             reference=reference)
    step = C if rows is None else rows.to(torch.int32) * C
    cache["pos"] = pos + step
    return _head(cfg, params, x), cache


def decode_fn(cfg: ModelConfig, params, inputs: dict, cache: dict, *,
              rows=None, reference: bool = False):
    """One decode step: token [B] against the cache (dense, int8 or paged;
    a paged cache's table may be narrowed to the pages the live rows
    need). ``rows`` [B] bool (default all) picks the rows whose cache and
    ``pos`` move, as in ``extend_fn``. Returns (logits [B, V], the cache,
    updated in place with ``pos += 1``)."""
    dev = _device(params)
    token = torch.as_tensor(inputs["token"], device=dev)
    pos = cache["pos"]
    x = Lyr.embed(params["embed"], token[:, None], cfg)
    if cfg.family == "ssm":
        x = _rwkv_forward(cfg, params, x, cache["state"], rows=rows,
                          step=True, reference=reference)
    elif cfg.family == "hybrid":
        x = _hybrid_forward(cfg, params, x, pos[:, None], cache["state"],
                            mode="decode", attn=cache["attn"], pos=pos,
                            rows=rows, reference=reference)
    else:
        kv, table = cache["kv"], cache.get("table")
        enc_len = None
        if "enc_kv" in cache:     # every row attends all Se encoder keys
            enc_len = torch.full((token.shape[0],),
                                 cache["enc_kv"]["k"].shape[2],
                                 dtype=torch.int32, device=dev)
        for i, p in enumerate(params["layers"]):
            x, _, _ = _layer(cfg, p, x, pos[:, None], mode="decode",
                             cache=_layer_cache(kv, i), pos=pos, rows=rows,
                             table=table, enc=_enc_layer(cache, i, enc_len),
                             reference=reference)
    cache["pos"] = pos + (1 if rows is None else rows.to(torch.int32))
    return _head(cfg, params, x), cache


def _kv_shapes(cfg: ModelConfig) -> dict:
    """Each cache leaf's shape per token: K and V [KVH, hd], or an MLA
    model's latents ``ckv`` [kv_lora] and ``kr`` [rope]."""
    if cfg.use_mla:
        return {"ckv": (cfg.kv_lora_rank,), "kr": (cfg.qk_rope_head_dim,)}
    shape = (cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": shape, "v": shape}


def _kv_leaves(cfg: ModelConfig, lead: tuple, dtype, device) -> dict:
    """Zeroed K/V leaves [*lead, KVH, hd]: int8 with fp32 scales
    [*lead, KVH] when ``dtype`` is "int8", else of ``dtype``. An MLA
    model's latent leaves [*lead, kv_lora] and [*lead, rope] have no int8
    layout."""
    if cfg.use_mla:
        if str(dtype) == "int8":
            raise ValueError(f"{cfg.name}: MLA latents are never quantized")
        return {name: torch.zeros((*lead, *shape), dtype=torch_dtype(dtype),
                                  device=device)
                for name, shape in _kv_shapes(cfg).items()}
    shape = (*lead, cfg.num_kv_heads, cfg.resolved_head_dim)
    if str(dtype) == "int8":
        z = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
        return {"k": z(shape, torch.int8),
                "k_scale": z(shape[:-1], torch.float32),
                "v": z(shape, torch.int8),
                "v_scale": z(shape[:-1], torch.float32)}
    dt = torch_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _with_enc_kv(cfg: ModelConfig, cache: dict, batch: int, dtype,
                 device) -> dict:
    """An encdec cache gains zeroed ``enc_kv`` [L,batch,Se,KVH,hd], dense
    per row whatever the self-attention's layout, in ``dtype`` (the
    model's when that is int8: the encoder's K/V are never quantized)."""
    if cfg.family == "encdec":
        dtype = cfg.dtype if str(dtype) == "int8" else dtype
        lead = (cfg.num_layers, batch, cfg.num_prefix_embeddings)
        cache["enc_kv"] = _kv_leaves(cfg, lead, dtype, device)
    return cache


def make_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
                      dtype=None) -> dict:
    """Zeroed decode cache for ``batch`` rows of ``max_seq`` tokens;
    ``dtype="int8"`` gives the quantized layout (an MLA model's latents
    have none). The ssm family's is its recurrent state, whatever
    ``max_seq`` and ``dtype``; the hybrid's its Mamba2 state beside one
    K/V cache a group (``attn``, int8 under ``dtype="int8"``)."""
    if cfg.family == "ssm":
        return {"state": RWKV.rwkv6_state_init(cfg, batch, device),
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}
    dtype = dtype or cfg.dtype
    if cfg.family == "hybrid":
        lead = (_zamba_grouping(cfg)[0], batch, max_seq)
        return {"state": hybrid_state_init(cfg, batch, device),
                "attn": _kv_leaves(cfg, lead, dtype, device),
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}
    lead = (cfg.num_layers, batch, max_seq)
    return _with_enc_kv(cfg, {
        "kv": _kv_leaves(cfg, lead, dtype, device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device)},
        batch, dtype, device)


def quantize_decode_cache(cache: dict) -> dict:
    """An fp decode cache (dense or paged) -> a new int8 one with
    per-(token, KV head) scales; ``pos``, the table and an encdec cache's
    ``enc_kv`` are shared. An MLA cache's latents, and a cache with no
    ``kv`` (the ssm family's state, the hybrid's state and ``attn``), are
    left as they are, as the reference leaves them (a new dict over the
    same leaves)."""
    if "k" not in cache.get("kv", {}):
        return dict(cache)
    k, ks = Lyr.quantize_kv(cache["kv"]["k"])
    v, vs = Lyr.quantize_kv(cache["kv"]["v"])
    return {**cache, "kv": {"k": k, "k_scale": ks, "v": v, "v_scale": vs}}


def supports_paged_cache(cfg: ModelConfig) -> bool:
    """Paged KV applies to the GQA attention families (dense, moe, vlm,
    an encdec model's self-attention; its ``enc_kv`` stays dense per row);
    MLA latents and the recurrent families keep O(1) state per token and
    stay dense."""
    return cfg.family not in ("ssm", "hybrid") and not cfg.use_mla


def make_paged_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                            device, *, page_size: int = 16,
                            num_pages: Optional[int] = None,
                            dtype=None) -> dict:
    """Paged (block-table) decode cache: pools [L, P+1, page, KVH, ...] of
    ``P = num_pages`` pages (default the dense capacity ``batch * max_seq
    / page_size``) plus the trash page, id P, which is also the sentinel
    that fills the table [batch, max_seq / page_size]."""
    if page_size <= 0 or page_size & (page_size - 1):
        raise ValueError(f"page_size {page_size} must be a power of two")
    if max_seq % page_size:
        raise ValueError(f"max_seq {max_seq} not a multiple of page_size")
    if not supports_paged_cache(cfg):
        raise ValueError(f"family {cfg.family!r} (use_mla={cfg.use_mla}) "
                         "has no paged layout: use make_decode_cache")
    maxP = max_seq // page_size
    P = num_pages if num_pages is not None else batch * maxP
    dtype = dtype or cfg.dtype
    lead = (cfg.num_layers, P + 1, page_size)
    return _with_enc_kv(cfg, {
        "kv": _kv_leaves(cfg, lead, dtype, device),
        "table": torch.full((batch, maxP), P, dtype=torch.int32,
                            device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device)},
        batch, dtype, device)

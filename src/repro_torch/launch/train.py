"""Training entry point: data -> train step -> checkpoint -> restart.

Port of ``repro/launch/train.py``. Runs real steps on the device it is
given: the card by default, whose attention forward and backward are
kernel 1 and its backward kernels, and whose WKV6 scan (the ssm family)
is kernel 7 and its backward kernel; ``--device cpu`` trains through the
plain PyTorch versions. The config is the arch's reduced smoke config on
the CPU and its published width on the card (``full_width_config``, as
``launch/serve.py`` serves it), ``--layers`` cutting the depth;
``--d-model`` takes the reference's reduced config at that width (four
heads). On the card a width whose head dim the family's backward kernels
do not take (``backward_head_dims``: kernel 1-bwd's ``BWD_HEAD_DIMS``,
64, 112, 128 and 256, for attention, 16 and 64 for WKV6; ``--d-model
768`` gives 192) is refused here, before any step. The dense family, the
moe family with GQA attention, the ssm family (rwkv6) and the hybrid
(zamba2, its shared attention at hd 112) train
(``models.transformer.loss_fn``); phi3.5-moe at its published width fits
one 80 GB card at 2 of its 32 layers, zamba2-7b at 13 of its 81 (2
groups of 6 Mamba2 layers and a tail layer). The encdec and vlm
families' losses take ``frames`` or ``patches`` that ``SyntheticLM``
does not make (nor does the reference's trainer): they are refused
here, and an encdec or vlm model (paligemma-3b whole, hd 256, its
patches a bidirectional prefix) trains through
``training.make_train_step`` on batches that carry them. AdamW's
learning rate defaults to ``default_lr(cfg)``: the reference's 3e-3 for a
reduced config, 3e-5 at a published width.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --steps 6 --seq 4096 \\
      --batch 8 --microbatches 4
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch phi3.5-moe-42b-a6.6b --layers 2 --steps 6 --seq 4096 \\
      --batch 4 --microbatches 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch rwkv6-1.6b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch zamba2-7b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --layers 13 --steps 6 --seq 4096 --batch 4 --microbatches 4
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention, wkv6
from repro_torch.launch.serve import full_width_config
from repro_torch.models.api import build
from repro_torch.training import AdamW, default_schedule, make_train_step
from repro_torch.tree import leaves


def backward_head_dims(cfg: ModelConfig) -> tuple:
    """The head dims the card's backward kernels take for ``cfg``'s
    family: kernel 7-bwd's for the ssm family, kernel 1-bwd's
    (``flash_attention.BWD_HEAD_DIMS``: 64, 112, 128 and 256) for the
    attention families, the hybrid's shared attention and the vlm
    family's hd 256 included."""
    if cfg.family == "ssm":
        return wkv6.BWD_HEAD_DIMS
    return flash_attention.BWD_HEAD_DIMS


def check_synthetic(cfg: ModelConfig) -> None:
    """ValueError for a family whose loss takes inputs ``SyntheticLM``
    does not make: encdec (``frames``) and vlm (``patches``)."""
    if cfg.family in ("encdec", "vlm"):
        what = "frames" if cfg.family == "encdec" else "patches"
        raise ValueError(
            f"{cfg.name} ({cfg.family}): its loss takes batch[{what!r}], "
            f"and SyntheticLM has no frames or patches (nor has the "
            f"reference's trainer); train it through "
            f"training.make_train_step on batches that carry them")


def train_config(arch: str, device, *, d_model: Optional[int] = None,
                 num_layers: Optional[int] = None) -> ModelConfig:
    """The config ``train_loop`` trains: the smoke config on the CPU, the
    published width on the card; ``d_model`` the reference's reduced
    config at that width, ``num_layers`` the depth. On the card its head
    dim must be one the family's backward kernels take
    (``backward_head_dims``; ValueError otherwise)."""
    cpu = resolve_device(device).type == "cpu"
    if d_model:
        cfg = reduced(get_config(arch), d_model=d_model, head_dim=None,
                      d_ff=int(d_model * 8 // 3 // 64 * 64) or 128)
    else:
        cfg = smoke_config(arch) if cpu else full_width_config(arch)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    dims = backward_head_dims(cfg)
    if not cpu and cfg.resolved_head_dim not in dims:
        raise ValueError(
            f"{cfg.name} at d_model {cfg.d_model} over {cfg.num_heads} heads "
            f"has head dim {cfg.resolved_head_dim}; the card's backward "
            f"kernels for the {cfg.family} family take {dims} (--d-model "
            f"{dims[-1] * cfg.num_heads} gives head dim {dims[-1]})")
    return cfg


# AdamW's rate for a reduced config (the reference's default) and for a
# model at its published width: llama3.2-1b whole spikes its loss after the
# first update at 1e-4 and above under a one-step warmup
SMOKE_LR = 3e-3
FULL_WIDTH_LR = 3e-5


def default_lr(cfg: ModelConfig) -> float:
    """``FULL_WIDTH_LR`` when ``cfg`` has its arch's published width, else
    ``SMOKE_LR``."""
    published = get_config(cfg.name).d_model
    return FULL_WIDTH_LR if cfg.d_model == published else SMOKE_LR


def train_loop(*, arch: str = "llama3.2-1b", steps: int, global_batch: int,
               seq_len: int, device=None, lr: Optional[float] = None,
               num_microbatches: int = 1,
               compress_grads: bool = False, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 50, resume: bool = False,
               log_every: int = 10, d_model: Optional[int] = None,
               num_layers: Optional[int] = None, seed: int = 0) -> dict:
    """Train ``steps`` steps of ``SyntheticLM`` batches under
    ``default_schedule`` (an encdec or vlm arch raises ValueError:
    ``check_synthetic``) and return the losses, each step's wall seconds
    (synchronised), tokens a second, the config
    (``train_config(arch, device, ...)``), the learning rate (``lr``, by
    default ``default_lr(cfg)``) and, on the card, the peak memory."""
    dev = resolve_device(device)
    cfg = train_config(arch, dev, d_model=d_model, num_layers=num_layers)
    check_synthetic(cfg)
    model = build(cfg)
    lr = default_lr(cfg) if lr is None else lr
    opt = AdamW(lr=lr)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                       global_batch=global_batch, seed=seed)
    step_fn = make_train_step(
        model.loss_fn, opt, num_microbatches=num_microbatches,
        compress_grads=compress_grads,
        schedule=default_schedule(steps, warmup=max(steps // 20, 1)))

    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    state = opt.init(params)
    start = 0
    store = CheckpointStore(ckpt_dir) if ckpt_dir else None
    if store and resume and store.latest_step() is not None:
        restored, extra = store.restore({"params": params, "opt": state})
        params, state = restored["params"], restored["opt"]
        start = int(extra.get("data_step", 0))
        print(f"[train] resumed from step {start}")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, seconds = [], []
    for i in range(start, steps):
        batch = data.batch(i, dev)
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))           # synchronises
        seconds.append(time.perf_counter() - t0)
        if log_every and (i + 1) % log_every == 0:
            print(f"[train] step {i + 1}/{steps} loss={losses[-1]:.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"({seconds[-1]:.2f}s/step)")
        if store and (i + 1) % ckpt_every == 0:
            store.save_async(i + 1, {"params": params, "opt": state},
                             extra={"data_step": i + 1,
                                    "loss": losses[-1]})
    if store:
        store.wait()
    n_params = sum(p.numel() for p in leaves(params))
    tokens = global_batch * seq_len
    out = {"losses": losses, "final_loss": losses[-1] if losses else None,
           "first_loss": losses[0] if losses else None, "params": n_params,
           "steps_run": len(losses), "step_seconds": seconds,
           "tokens_per_s": [tokens / s for s in seconds], "cfg": cfg,
           "lr": lr, "device": str(dev)}
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), default="llama3.2-1b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=None,
                    help=f"AdamW's rate (default: {SMOKE_LR} for a reduced "
                         f"config, {FULL_WIDTH_LR} at a published width)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--d-model", type=int, default=None,
                    help="the reference's reduced config at this width")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    try:     # refuse a width or family it cannot train before any step
        check_synthetic(train_config(args.arch, args.device,
                                     d_model=args.d_model,
                                     num_layers=args.layers))
    except ValueError as e:
        ap.error(str(e))
    out = train_loop(arch=args.arch, steps=args.steps,
                     global_batch=args.batch, seq_len=args.seq,
                     device=args.device, lr=args.lr,
                     d_model=args.d_model, num_layers=args.layers,
                     num_microbatches=args.microbatches,
                     compress_grads=args.compress_grads,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     resume=args.resume)
    print(f"[train] done: {out['steps_run']} steps, "
          f"{out['params'] / 1e6:.1f}M params, "
          f"lr {out['lr']}, loss {out['first_loss']:.4f} -> "
          f"{out['final_loss']:.4f} on {out['device']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""End to end: train a ~100M-parameter LM for a few hundred steps.

Port of the reference's ``examples/train_100m.py``::

    PYTHONPATH=src python -m repro_torch.examples.train_100m \
        [--steps 300] [--small] [--ckpt-dir DIR] [--device cuda|cpu]

A ~110M dense transformer (12 layers of 768 x 3072 from the gemma family
config, vocab 32,768) with the whole substrate in play: the deterministic
data pipeline, AdamW with f32 master weights, async checkpointing with
keep-last-k, the cosine schedule; it resumes from the newest checkpoint in
``--ckpt-dir``.  ``--small`` shrinks the width for a fast demonstration
with the same plumbing.  Runs on the card unless ``--device cpu``.
"""

import argparse
import logging
import time

import torch

from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_state

log = logging.getLogger("train100m")


def config_100m(small: bool):
    base = get_config("gemma_2b")
    if small:
        return base.replace(n_layers=4, d_model=256, n_heads=4, n_kv_heads=1,
                            d_ff=1024, vocab_size=8192, max_seq_len=512)
    # ~110M backbone (excl. embeddings): 12L x 768 x 3072
    return base.replace(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                        d_ff=3072, vocab_size=32_768, max_seq_len=1024)


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default="repro_100m_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; pass "
                           "--device cpu to run on the CPU")

    cfg = config_100m(args.small)
    model = build_model(cfg, device=device, use_kernel=False,
                        attn_impl="chunked", remat_policy="full",
                        loss_chunk=1024)
    log.info("config: %dL d=%d ff=%d vocab=%d  ~%.0fM params",
             cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
             cfg.param_count() / 1e6)

    opt_cfg = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps)
    data_cfg = DataConfig(seq_len=args.seq_len,
                          global_batch=args.global_batch,
                          vocab_size=cfg.vocab_size, seed=0)

    params = dict(model.named_parameters())
    opt = init_state(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg)
    saver = AsyncCheckpointer(args.ckpt_dir, keep=2)

    start = 0
    last = latest_step(args.ckpt_dir)
    if last is not None:
        tree, _ = restore(args.ckpt_dir, last,
                          {"params": params, "opt": opt})
        params, opt = tree["params"], tree["opt"]
        start = last
        log.info("resumed from step %d", start)

    t0 = time.time()
    metrics = {}
    for step in range(start, args.steps):
        batch = synthetic_batch(data_cfg, step, device=device)
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 20 == 0 or step == args.steps - 1:
            log.info("step %4d loss=%.4f lr=%.2e  %.2fs/step", step,
                     float(metrics["loss"]), float(metrics["lr"]),
                     (time.time() - t0) / max(step - start + 1, 1))
        if step and step % 100 == 0:
            saver.save_async(step, {"params": params, "opt": opt})
    saver.save_async(args.steps, {"params": params, "opt": opt})
    saver.wait()
    final = float(metrics["loss"]) if metrics else None
    log.info("done; final loss %s", final)
    return {"steps": args.steps, "start": start, "final_loss": final}


if __name__ == "__main__":
    main()

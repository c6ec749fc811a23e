"""End-to-end driver on the port: train a ~100M-parameter qwen3-family LM
on the card, with the full production substrate engaged — byte-range
sharded data pipeline, prefetch, AdamW + cosine schedule, async sharded
checkpoints, restart-capable Trainer.

Use --steps 20 for a smoke run; ``--device cpu`` runs the plain versions
on the host (slow at the default sizes: shrink ``--batch``, ``--seq`` and
``--corpus-words``).

    PYTHONPATH=src python examples_torch/train_lm.py --steps 200
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 3 \\
        --batch 2 --seq 32 --corpus-words 20000
"""

import argparse

from repro_torch import configs
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.storage import MemoryStore
from repro_torch.data import HashTokenizer, PackedLMDataset, Prefetcher
from repro_torch.data.pipeline import make_store_with_corpus
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.runtime import Trainer, TrainerConfig


def build_100m_config():
    """~100M params in the qwen3 family: 12L, d=512, 8 heads (kv=4),
    d_ff=2048, vocab=32768 → ≈ 72M embed + 38M blocks ≈ 110M."""
    return configs.get("qwen3-32b").replace(
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab=32_768,
        param_dtype="float32", compute_dtype="float32", remat=False)


def main(argv=None) -> list:
    """Train; returns the Trainer's metrics log."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--corpus-words", type=int, default=2_000_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    cfg = build_100m_config()
    print(f"[train_lm] {cfg.n_params()/1e6:.0f}M params, "
          f"{args.steps} steps of {args.batch}×{args.seq} tokens")

    store, prefix = make_store_with_corpus(args.corpus_words, vocab_words=20_000)
    ds = PackedLMDataset(store, prefix, HashTokenizer(cfg.vocab),
                         batch=args.batch, seq_len=args.seq)
    opt = AdamW(lr=cosine_schedule(args.lr, args.steps // 10, args.steps))
    # at least two metrics records, so that a short run can show the loss
    # falling (every 10 steps from 20 steps on, as the reference logs)
    trainer = Trainer(cfg, opt, MemoryStore(), MetadataStore(),
                      TrainerConfig(checkpoint_every=max(50, args.steps // 4),
                                    log_every=max(1, min(10,
                                                         args.steps // 2))),
                      device=args.device)
    trainer.run(Prefetcher(iter(ds)), args.steps)
    trainer.close()
    first, last = trainer.metrics_log[0], trainer.metrics_log[-1]
    print(f"[train_lm] loss {first['loss']:.3f} → {last['loss']:.3f} "
          f"({last['steps_per_s']:.2f} steps/s)")
    assert last["loss"] < first["loss"], "training must reduce loss"
    return trainer.metrics_log


if __name__ == "__main__":
    main()

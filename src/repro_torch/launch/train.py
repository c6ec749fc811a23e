"""Training launcher: the partner of ``repro/launch/train.py``.

Trains an architecture on the synthetic corpus through the whole training
plane — the packed data pipeline and its prefetcher, AdamW on a cosine
schedule, the Trainer with async checkpoints, restart and retries.
Entry points default to the card; on a host without CUDA pass
``--device cpu`` (with ``--reduced``, the tiny same-family config)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-9b \\
        --reduced --device cpu --steps 4
"""

from __future__ import annotations

import argparse
import json

from .. import configs
from ..core.metadata import MetadataStore
from ..core.storage import FileStore, MemoryStore
from ..data import HashTokenizer, PackedLMDataset, Prefetcher
from ..data.pipeline import make_store_with_corpus
from ..optim import AdamW
from ..optim.schedule import cosine_schedule
from ..runtime import Trainer, TrainerConfig


def main(argv=None) -> None:
    """Parse the reference's flags (plus ``--device``) and train.  An
    embeddings architecture is refused with the reference's
    ``SystemExit``: the synthetic corpus is token ids."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None,
                    help="filesystem checkpoint dir (default: in-memory)")
    ap.add_argument("--corpus-words", type=int, default=500_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get(args.arch)
    if cfg.input_mode == "embeddings":
        raise SystemExit(f"{args.arch} trains on frontend embeddings; use "
                         "examples/train_lm.py for token-LM training")

    corpus_store, prefix = make_store_with_corpus(args.corpus_words)
    tok = HashTokenizer(cfg.vocab)
    ds = PackedLMDataset(corpus_store, prefix, tok, batch=args.batch,
                         seq_len=args.seq, seed=args.seed)
    batches = Prefetcher(iter(ds))

    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps),
                weight_decay=0.1)
    ckpt_store = FileStore(args.ckpt_dir) if args.ckpt_dir else MemoryStore()
    trainer = Trainer(
        cfg, opt, ckpt_store, MetadataStore(),
        TrainerConfig(checkpoint_every=args.ckpt_every,
                      microbatches=args.microbatches),
        seed=args.seed, device=args.device)
    print(f"[train] {cfg.name}: {cfg.n_params()/1e6:.1f}M params, "
          f"resuming from step {trainer.start_step}")
    trainer.run(batches, args.steps)
    for m in trainer.metrics_log:
        print(json.dumps(m))


if __name__ == "__main__":
    main()

"""Serving example on the port: batched request serving with KV caches and
slot reuse (continuous-batching-lite), on a reduced gemma2 (alternating
local/global windows + softcaps — the serving-hard arch of the pool).  On
the card every decode step's attention is the ``decode_cluster`` kernel.

    PYTHONPATH=src python examples_torch/serve_lm.py                # the card
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu   # plain versions
"""

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import init_params


def main(argv=None) -> int:
    """Serve ten requests; returns the tokens served."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    cfg = configs.get_reduced("gemma2-9b")
    params = init_params(0, cfg, device=args.device)
    server = BatchedServer(cfg, params, n_slots=4, max_len=96,
                           device=args.device)

    rng = np.random.default_rng(0)
    n_requests, prompt_len, max_new = 10, 12, 24
    for i in range(n_requests):
        server.submit(Request(
            id=i,
            prompt=rng.integers(0, cfg.vocab, prompt_len, dtype=np.int32),
            max_new=max_new))

    t0 = time.perf_counter()
    steps, served = 0, 0
    while any(server.slots) or server.queue:
        served += server.step()
        steps += 1
    dt = time.perf_counter() - t0
    print(f"[serve_lm] {n_requests} requests × {max_new} new tokens: "
          f"{served} tokens in {dt:.2f}s "
          f"({served/dt:.1f} tok/s, {steps} batched steps, "
          f"{steps/n_requests:.1f} steps/request)")
    assert served == n_requests * max_new
    return served


if __name__ == "__main__":
    main()

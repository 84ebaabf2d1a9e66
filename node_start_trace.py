"""Trace block sync through a started node on the card.

Runs chip_smoke.py's catch-up chain (config 5's mixed 10k set, 8 blocks
of 10,000 kvstore txs) and its `block_sync` phase, then its `node_start`
phase `--runs` times, and writes to stderr, each line stamped with the
seconds since the start: every block request of the block pool (height,
peer), every block's arrival, each verify-and-apply with its seconds and
its block store save's, every 1,000th tx the indexer indexes, and every
full (generation 2) garbage collection with its seconds. chip_smoke's own JSON lines go to stdout.

    python3 node_start_trace.py [--runs 2] > out.txt 2> trace.txt

Needs CUDA; run it from the root of the repository.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import time

_T0 = time.perf_counter()


def log(*parts) -> None:
    print(f"[{time.perf_counter() - _T0:8.2f}]", *parts, file=sys.stderr, flush=True)


def instrument() -> None:
    """Wrap the block pool, the block sync reactor's verify-and-apply and
    the block store's save and the indexer's tx handler so that each
    logs, and log full collections."""
    from tendermint_tpu_torch.blocksync import pool as P
    from tendermint_tpu_torch.blocksync import reactor as R
    from tendermint_tpu_torch.state import indexer as I
    from tendermint_tpu_torch.store import block_store as BS

    pool_init = P.BlockPool.__init__

    def init(self, start_height, send_request):
        def request(height, peer_id):
            log(f"request h={height} peer={peer_id[:6]}")
            return send_request(height, peer_id)

        pool_init(self, start_height, request)

    add_block = P.BlockPool.add_block

    def added(self, peer_id, block):
        log(f"arrived h={block.header.height} from={peer_id[:6]}")
        return add_block(self, peer_id, block)

    verify_apply = R.BlocksyncReactor._verify_apply

    async def timed_verify_apply(self, first, second):
        t = time.perf_counter()
        log(f"verify_apply start h={first.header.height}")
        await verify_apply(self, first, second)
        log(f"verify_apply end h={first.header.height} {time.perf_counter() - t:.2f}s")

    save_block = BS.BlockStore.save_block

    def timed_save(self, *args, **kwargs):
        t = time.perf_counter()
        out = save_block(self, *args, **kwargs)
        log(f"  save_block {time.perf_counter() - t:.3f}s")
        return out

    on_tx = I.IndexerService._on_tx
    indexed = [0]

    def counted_on_tx(self, data):
        on_tx(self, data)
        indexed[0] += 1
        if indexed[0] % 1000 == 0:
            log(f"indexed {indexed[0]} txs (h={data.height} index={data.index})")

    P.BlockPool.__init__ = init
    I.IndexerService._on_tx = counted_on_tx
    P.BlockPool.add_block = added
    R.BlocksyncReactor._verify_apply = timed_verify_apply
    BS.BlockStore.save_block = timed_save

    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif info["generation"] == 2:
            log(f"gc gen2 {time.perf_counter() - started['t']:.2f}s collected={info['collected']}")

    gc.callbacks.append(on_gc)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2, help="node_start phases to run")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("node_start_trace: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    os.chdir(here)
    import chip_smoke as C
    from tendermint_tpu_torch.ops import build

    instrument()
    print(C.nvidia_smi_line(), flush=True)
    t = time.perf_counter()
    build.kernels()
    log(f"kernels built {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    served = C.catchup_chain(args.seed)
    log(f"=== chain built {time.perf_counter() - t:.1f}s; block_sync")
    block_sync = C.phase_block_sync(torch, args.seed, served)
    for i in range(args.runs):
        log(f"=== node_start {i}")
        C.phase_node_start(torch, args.seed, served, block_sync)
    log("=== done")
    return 0


if __name__ == "__main__":
    sys.exit(main())

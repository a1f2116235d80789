"""Dependent-gather microbenchmark (kernel K12, kernels/csrc/dep_gather.cu).

Port of the Pallas probe in the JAX package's tools/micro_gather.py
(`kern` / `pallas_dep`): B = 32,768 lanes each make NITER = 100 dependent
fetches of a row of a uint32 [19,532, 21] table, idx <- (row[0] ^ row[20]) %
NROW; the result is each lane's last index.  The shape is the FM chain
search's: a row fetch whose address depends on the previous one.  The table
(1.6 MB) lives in device memory and the L2 cache serves it; the Pallas kernel
held it in VMEM.

  python -m centrifuger_tpu_torch.tools.micro_gather [--device cuda] [--seed S]

prints the kernel's time against its plain PyTorch twin on the same inputs.
"""

import argparse
import time

import numpy as np
import torch

from .. import kernels
from ..fm.device import resolve_device

B = 32768            # 2 * (2 * 8192) boundary lanes
NROW = 19532         # 5e6 / 256 fused rows
NCOL = 21            # 84-byte rows
NITER = 100
_M32 = 0xFFFFFFFF


def make_inputs(seed, device, nrow=NROW, lanes=B):
    """(table int32 [nrow, 21] holding uint32 words below 2^30, idx int32
    [lanes] in [0, nrow)) from a numpy seed, as the JAX probe draws them."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 30, (nrow, NCOL), dtype=np.uint32).view(np.int32)
    idx = rng.integers(0, nrow, lanes).astype(np.int32)
    return torch.from_numpy(table).to(device), torch.from_numpy(idx).to(device)


def dep_gather_plain(table, idx, iters=NITER):
    """Plain twin: the same chain as batched tensor code."""
    t = table.long() & _M32
    cur = idx.long()
    for _ in range(iters):
        cur = (t[cur, 0] ^ t[cur, NCOL - 1]) % table.shape[0]
    return cur.int()


def dep_gather(table, idx, iters=NITER):
    """K12 wrapper: table int32 [nrow, 21] (uint32 words), idx int32 [B] in
    [0, nrow) -> int32 [B], each lane's index after `iters` fetches."""
    if table.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError("dep_gather: table and idx must be int32")
    if table.dim() != 2 or table.shape[1] != NCOL or idx.dim() != 1:
        raise ValueError("dep_gather: want table [nrow, %d] and idx [B]" % NCOL)
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("dep_gather: inputs must be contiguous")
    if table.device != idx.device:
        raise ValueError("dep_gather: table and idx on different devices")
    if idx.device.type == "cpu":
        return dep_gather_plain(table, idx, iters)
    out = torch.empty_like(idx)
    if len(idx):
        kernels.launch_raw("dep_gather", idx.device, table, table.shape[0], idx,
                           len(idx), iters, out)
    return out


def run(device="cuda", seed=0):
    """The microbenchmark: (kernel result, twin result, kernel ms, twin ms).
    On the CPU both are the twin and the times are host times."""
    device = resolve_device(device)
    table, idx = make_inputs(seed, device)
    cuda = device.type == "cuda"

    def timed(fn):
        fn()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3
    got, ms = timed(lambda: dep_gather(table, idx))
    want, plain_ms = timed(lambda: dep_gather_plain(table, idx))
    return got, want, ms, plain_ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    got, want, ms, plain_ms = run(args.device, args.seed)
    print("dep_gather [%d lanes x %d iters, table %d x %d u32] on %s: %.3f ms "
          "(plain twin %.3f ms), equal to the twin: %s"
          % (B, NITER, NROW, NCOL, args.device, ms, plain_ms, bool(torch.equal(got, want))))
    return 0 if torch.equal(got, want) else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""The data-parallel classify step (kernel K11).

Port of centrifuger_tpu.parallel.mesh.  The JAX step shards a batch of code
lanes over a device mesh, replicates the index on every chip, runs the chain
search and resolves each hit's start row inside one jitted program, and sums
the hits with a psum (an all-reduce over ICI).  It has no body of its own
beyond kernels K1 and K2, so here it is their launches on each device's
replica of the index: the lanes split into one part a device of `devices`
(a device named twice takes two parts), each part runs chain_search_lanes
(K1, code lanes) and resolve_rows (K2) on its hits' start rows, and the
parts are gathered on the first device.  total_hits is the sum of the parts'
hit counts.  No library call stands in for either kernel.
"""

import copy

import torch

from ..fm.device import chain_search_lanes, resolve_device, resolve_rows


def make_mesh(n_devices=None, devices=None):
    """The devices of a data-parallel run (the JAX make_mesh's device list):
    `devices`, or every CUDA device, cut to the first n_devices."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise RuntimeError("no device to run on: torch.cuda.device_count() is 0; pass "
                           "devices=['cpu'] to run the plain PyTorch versions")
    return devices


def classify_dp_step(fm, devices, min_hit_len, max_hits):
    """K11: a step (codes uint8 [B, L], lengths int32 [B]) -> dict of nhits
    [B] int32, sp / ep [B, H] in the index type, l / off [B, H] int32, seqids
    [B, H] (the resolved start row of each hit, 0 past nhits) and total_hits
    (int64 scalar), all on devices[0].  fm is a TorchFM; one replica of it is
    kept on each distinct device of `devices`."""
    devices = [concrete(resolve_device(d)) for d in devices]
    replicas = {}
    for d in devices:
        if d not in replicas:
            replicas[d] = fm if fm.device == d else _replica(fm, d)
    H = max_hits

    def step(codes, lengths):
        B, G = codes.shape[0], len(devices)
        parts = []
        for g, d in enumerate(devices):
            a, b = B * g // G, B * (g + 1) // G
            rep = replicas[d]
            hits, nh = chain_search_lanes(rep, codes[a:b].to(d), lengths[a:b].to(d),
                                          min_hit_len, H)
            has_hit = torch.arange(H, device=d)[None, :] < nh[:, None]
            rows = torch.where(has_hit, hits[:, :, 0], torch.zeros_like(hits[:, :, 0]))
            seqids = resolve_rows(rep, rows.reshape(-1), has_hit.reshape(-1))
            parts.append((nh, hits, seqids.reshape(b - a, H), nh.sum(dtype=torch.int64)))
        first = devices[0]

        def cat(i):
            return torch.cat([p[i].to(first) for p in parts])
        hits = cat(1)
        return dict(nhits=cat(0), sp=hits[:, :, 0], ep=hits[:, :, 1],
                    l=hits[:, :, 2].int(), off=hits[:, :, 3].int(), seqids=cat(2),
                    total_hits=sum(p[3].to(first) for p in parts))
    return step


def concrete(device):
    """A CUDA device with its index (the current device's where none is
    given), so that devices compare equal and peer access can name them."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _replica(fm, device):
    """A copy of the TorchFM fm with its buffers on `device`; fm keeps its
    own.  The copy's sub-tables (the generic layout's bitvector and streams)
    count their traffic on the copy."""
    rep = copy.copy(fm)
    rep._buffers = dict(fm._buffers)
    rep._modules = {}
    for k, m in fm._modules.items():
        sub = None
        if m is not None:
            sub = copy.copy(m)
            sub._buffers = dict(m._buffers)
            sub.account = rep.account
        rep._modules[k] = sub
    return rep.to(device)

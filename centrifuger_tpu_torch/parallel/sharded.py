"""Sharded-index serving: the big FM tables row-sharded (kernel K10).

Port of centrifuger_tpu.parallel.sharded.  For a database whose index exceeds
one card's memory, the three big tables of the plain layout (the 512-byte
wide rank rows, the rowmap and the sampled SA) are cut into D shards of `rps`
rows each (the last one zero-padded, as the JAX package pads them), so each
shard holds about total / D of them; the small tables (ftab, psum, the
selected rows, the end-marker SA) stay whole, one copy on every device that
holds shards.  No whole copy of a sharded table is kept anywhere.

The JAX program routes every big-table fetch with collectives inside its
lockstep loops (all_gather of the request ids, a masked local gather,
psum_scatter).  Here the kernels look the owner up themselves: row r of a
sharded table lives at shards[r // rps] + r % rps, and each device that
launches holds a table of the D shard addresses (the `plain_sharded` layout
of kernels/csrc/fm_device.cuh).  A shard on another card is read over NVLink
with peer access on, enabled for every ordered pair of the devices that hold
shards when the index is made; where that cannot be done, it raises.  One
thread still runs one lane to completion, so there is no lockstep.

The shards go round-robin over the devices the caller gives (default: the
first min(D, torch.cuda.device_count()) CUDA devices); on one card all D sit
on it, and every fetch still routes.  On CPU tensors the twins run, with
their fetches routed by routed_gather, K10's plain version.  Results equal
the unsharded index's bit for bit.
"""

import torch
from torch import nn

from .. import kernels
from ..fm.device import TorchFM, resolve_device
from .mesh import concrete, make_mesh

SHARDED = ("rows", "rowmap", "sampled_sa")    # JAX: plain_rows, rowmap, sampled_sa
REPLICATED = ("ftab", "psum", "sel_rows", "sel_vals", "end_marker_sa")
SCALARS = ("n", "sigma", "idtype", "code_bits", "pw", "first_isa", "last_chr",
           "sample_rate", "adjusted_sa0", "ftab_size", "b", "b_lt_n")


def routed_gather(shards, idx, rps):
    """K10's plain version (_routed_gather): rows idx [M] (int64) of a table
    row-sharded into `shards` (each [rps, ...], on any device) -> [M, ...] on
    idx's device.  An id outside [0, rps * len(shards)) gives 0."""
    owner = torch.div(idx, rps, rounding_mode="floor")
    local = idx - owner * rps
    out = torch.zeros((len(idx),) + tuple(shards[0].shape[1:]), dtype=shards[0].dtype,
                      device=idx.device)
    for s, t in enumerate(shards):
        sel = (owner == s).nonzero()[:, 0]
        if len(sel):
            out[sel] = t[local[sel].to(t.device)].to(idx.device)
    return out


class _PoisonTable:
    """Stands for a sharded table: passes `is not None` checks, fails loudly
    on any other use (an unrouted access)."""

    def __getitem__(self, k):
        raise RuntimeError("sharded table accessed without routing")

    def __len__(self):
        raise RuntimeError("sharded table accessed without routing")

    def __getattr__(self, k):
        raise RuntimeError("sharded table accessed without routing")


class _ShardView(TorchFM):
    """One device's view of a sharded index: the small tables on `device`,
    the big ones read from their shards.  The twins route through the fetch
    hooks; the kernels read the shard-address table `ptrs`."""

    def __init__(self, host, shards, rps, device):
        nn.Module.__init__(self)
        for k in SCALARS:
            setattr(self, k, getattr(host, k))
        self.layout = "plain_sharded"
        self.traffic = None
        for k in REPLICATED:
            t = getattr(host, k)
            self.register_buffer(k, None if t is None else t.to(device, copy=True))
        self.shards, self.rps = shards, rps
        for k in SHARDED:
            setattr(self, k, _PoisonTable() if k in shards else None)
        D = len(shards["rows"])
        self.ptrs = torch.tensor(
            [[t.data_ptr() for t in shards[k]] if k in shards else [0] * D
             for k in SHARDED], dtype=torch.int64, device=device)

    # the rank layout is the plain one, with routed row fetches
    def rank_sym(self, c, pos):
        return self._plain_rank_sym(c, pos)

    def lf(self, p):
        return self._plain_lf(p)

    # K10's plain version: each big-table read routed to its owner shard.  The
    # traffic account is the unsharded index's: the kernels' shard-address
    # table (3 D addresses) is read from L1, not once a fetch from memory

    def _plain_rows_fetch(self, r):
        return routed_gather(self.shards["rows"], r, self.rps["rows"])

    def _rowmap_fetch(self, rows):
        self.account(lambda: 4 * len(rows))
        return routed_gather(self.shards["rowmap"], rows, self.rps["rowmap"])

    def _sampled_sa_fetch(self, slot):
        return routed_gather(self.shards["sampled_sa"], slot, self.rps["sampled_sa"])

    def shard_fields(self):
        """The FMView fields of the sharded layout (kernels._fm_view)."""
        base, row = self.ptrs.data_ptr(), self.ptrs.stride(0) * 8
        has_rowmap = self.rowmap is not None    # None where the caller turned it off
        return dict(rows_shards=base, rowmap_shards=base + row if has_rowmap else None,
                    sampled_shards=base + 2 * row, rps_rows=self.rps["rows"],
                    rps_map=self.rps.get("rowmap", 0), rps_sa=self.rps["sampled_sa"],
                    n_shards=len(self.shards["rows"]), has_rowmap=int(has_rowmap))


class ShardedIndex(_ShardView):
    """The serving index with its big tables row-sharded into n_shards shards
    over `devices`.  It is the view of the first device that holds shards, so
    every wrapper of fm/device.py and classify/device_engine.py (the JAX
    ShardedIndex's chain_search, resolve_rows, prefix_search and
    fused_classify) takes it as its index and launches there (the
    `plain_sharded` instantiations); `views` holds one view a device, and
    fused_classify runs each device's share of the units on it
    (over_devices).

    fm is a TorchFM on the plain layout (its tables are cut into shards; the
    caller may drop it) or fm_arrays(fm) (loaded on the host first, then cut,
    so no device holds a whole table); force_idtype applies to the latter."""

    def __init__(self, fm, n_shards, devices=None, force_idtype=None):
        host = fm if isinstance(fm, TorchFM) else TorchFM(fm, "cpu", "plain", force_idtype)
        if host.layout != "plain":
            raise ValueError("sharded serving needs the plain serving layout (its wide "
                             "rank rows are what is sharded), not %r" % host.layout)
        D = int(n_shards)
        if D < 1:
            raise ValueError("n_shards must be at least 1, got %d" % D)
        if devices is None:
            resolve_device("cuda")     # raises without a card
            devices = make_mesh(n_devices=min(D, torch.cuda.device_count()))
        devices = [concrete(resolve_device(d)) for d in devices]
        placement = [devices[s % len(devices)] for s in range(D)]
        holders = list(dict.fromkeys(placement))
        shards, rps = {}, {}
        for k in SHARDED:
            t = getattr(host, k)
            if t is None:
                continue
            r = -(-t.shape[0] // D)
            rps[k] = r
            shards[k] = []
            for s, dev in enumerate(placement):
                # copied in place: no device holds a temporary of the slice
                part = torch.empty((r,) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
                src = t[s * r:(s + 1) * r]
                part[:len(src)].copy_(src)
                part[len(src):].zero_()
                shards[k].append(part)
        if holders[0].type == "cuda":
            for d in holders:
                for p in holders:
                    if d != p:
                        kernels.enable_peer_access(d.index, p.index)
        super().__init__(host, shards, rps, holders[0])
        self.placement = placement
        self.views = [self] + [_ShardView(host, shards, rps, d) for d in holders[1:]]

    @property
    def n_shards(self):
        return len(self.placement)

    # ------------------------------------------------------ memory accounting

    def per_shard_bytes(self):
        """(the largest shard's bytes of the sharded tables, their total
        bytes): the sharded-mode contract per_shard ~= total / D."""
        per = sum(max(_nbytes(t) for t in ts) for ts in self.shards.values())
        return per, sum(_nbytes(t) for ts in self.shards.values() for t in ts)

    def replicated_bytes(self):
        """Bytes of the small tables each device that holds shards keeps."""
        return sum(_nbytes(t) for t in (getattr(self, k) for k in REPLICATED)
                   if t is not None)

    def per_device_bytes(self):
        """{device: bytes of the index on it}: its shards and the replicated
        tables."""
        out = {str(v.device): self.replicated_bytes() for v in self.views}
        for ts in self.shards.values():
            for t in ts:
                out[str(t.device)] += _nbytes(t)
        return out

    def placement_text(self):
        """One line: where the shards sit, and the bytes a shard and a device
        hold."""
        per, total = self.per_shard_bytes()
        names = {"rows": "wide rows", "rowmap": "rowmap", "sampled_sa": "sampled SA"}
        return ("sharded index: %d shards of the %s over %s; per shard %.1f MB of "
                "%.1f MB, per device %s (replicated tables %.1f MB each)"
                % (self.n_shards, ", ".join(names[k] for k in self.shards),
                   ", ".join(str(d) for d in self.placement), per / 1e6, total / 1e6,
                   ", ".join("%s %.1f MB" % (d, b / 1e6)
                             for d, b in self.per_device_bytes().items()),
                   self.replicated_bytes() / 1e6))

    def over_devices(self, fn, rows_per_unit, *tensors):
        """fn(view, *tensors) -> a tuple of tensors ordered by unit along dim
        0.  With one device, one call covers the batch; over G devices the
        units (rows_per_unit rows of each input) split into G runs of whole
        units, each run goes to its device, and the outputs are gathered on
        the first."""
        if len(self.views) == 1:
            return super().over_devices(fn, rows_per_unit, *tensors)
        Q, G = tensors[0].shape[0] // rows_per_unit, len(self.views)
        outs = []
        for g, view in enumerate(self.views):
            a, b = (Q * g // G) * rows_per_unit, (Q * (g + 1) // G) * rows_per_unit
            outs.append(fn(view, *(t[a:b].to(view.device) for t in tensors)))
        return tuple(torch.cat([o[i].to(self.device) for o in outs])
                     for i in range(len(outs[0])))


def _nbytes(t):
    return t.numel() * t.element_size()

"""EquiformerV2 (Liao et al. 2023) — equivariant graph attention with
eSCN-style SO(2) convolutions (``repro/models/gnn/equiformer_v2.py``).

Mechanics:
  * node features are real-SH irrep stacks  X in R^{N x S x C},
    S = (l_max+1)^2, C sphere channels;
  * per edge, source features are rotated into the edge-aligned frame
    (``so3.rotation_to_z`` + Wigner-D from the Ivanic recursion), where the
    SO(3) tensor-product convolution reduces to dense per-m linear maps
    with |m| <= m_max (the eSCN O(L^6) -> O(L^3) trick);
  * multi-head attention: invariant (l=0) query/key features produce
    per-edge logits, normalised over incoming edges, weighting the full
    irrep message;
  * messages are rotated back and scatter-summed; equivariant RMS norm and
    a gated equivariant FFN complete the block.

The simplifications against the released model are the reference's: the
distance-dependent filter is a per-edge channel gate, and the S2
pointwise activation an equivariant sigmoid gate.

Scaling: edges are walked in fixed-size chunks (a Python loop, the
reference's ``lax.scan``), accumulating the softmax's numerator and
denominator. Wigner matrices are built inside each chunk from the (E, 3)
unit vectors, never for the whole edge set. Degenerate edges (pads /
zero-length) carry no valid frame and are masked. With
``edge_shard_axes`` and a ``mesh``, each chunk is split over the mesh's
devices on those axes (``forward``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import torch
import torch.nn.functional as F

from repro_torch.models import common as mcommon
from repro_torch.models.gnn import common as g
from repro_torch.models.gnn import so3
from repro_torch.obs import opcost_hooks


@dataclasses.dataclass(frozen=True)
class EqV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    channels: int = 128          # sphere channels (d_hidden)
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 64
    cutoff: float = 12.0
    n_species: int = 100
    edge_chunk: int = 8192
    edge_shard_axes: tuple = ()   # mesh axes to shard each edge chunk over
    dtype: Any = torch.float32
    #: every layer of the ``n_layers`` stack has the same shapes and work,
    #: so the dry run counts the stack at two depths and extends the counts
    #: (``launch/dryrun.py``'s depth rule)
    repeated_layers: ClassVar[bool] = True

    @property
    def s_dim(self) -> int:
        return (self.l_max + 1) ** 2


def _m_indices(l_max: int, m: int) -> tuple[list[int], list[int]]:
    """S-dim indices of the (+m, -m) coefficients for all l >= |m|."""
    if m == 0:
        pos = [l * l + l for l in range(l_max + 1)]
        return pos, pos
    pos = [l * l + l + m for l in range(m, l_max + 1)]
    neg = [l * l + l - m for l in range(m, l_max + 1)]
    return pos, neg


def init_params(cfg: EqV2Config, generator=None, *, device=None):
    """(params, logical axes) at random init on ``device`` (None: the
    CUDA device; ``"meta"``: shapes only)."""
    f = mcommon.init_factory(generator, cfg.dtype, device)
    c, L = cfg.channels, cfg.l_max
    p = {"embed": f.dense((cfg.n_species, c), ("gnn_in", "gnn_out"),
                          scale=1.0),
         "rbf0": f.dense((cfg.n_rbf, c), ("gnn_in", "gnn_out")),
         "rbf0b": f.zeros((c,), ("gnn_out",))}
    for i in range(cfg.n_layers):
        n0 = L + 1
        p[f"so2_m0_{i}"] = f.dense((n0 * c, n0 * c), ("gnn_in", "gnn_out"))
        for m in range(1, cfg.m_max + 1):
            nl = L + 1 - m
            p[f"so2_r{m}_{i}"] = f.dense((nl * c, nl * c),
                                         ("gnn_in", "gnn_out"))
            p[f"so2_i{m}_{i}"] = f.dense((nl * c, nl * c),
                                         ("gnn_in", "gnn_out"), scale=1e-2)
        p[f"gate_{i}"] = f.dense((cfg.n_rbf, c), ("gnn_in", "gnn_out"))
        p[f"gateb_{i}"] = f.zeros((c,), ("gnn_out",))
        p[f"attn_q_{i}"] = f.dense((c, cfg.n_heads), ("gnn_in", "gnn_out"))
        p[f"attn_k_{i}"] = f.dense((c, cfg.n_heads), ("gnn_in", "gnn_out"))
        p[f"proj_{i}"] = f.dense((c, c), ("gnn_in", "gnn_out"), scale=0.02)
        p[f"norm_{i}"] = f.ones((L + 1, c), ("gnn_l", "gnn_out"))
        p[f"ffn_in_{i}"] = f.dense((c, c), ("gnn_in", "gnn_out"))
        p[f"ffn_gate_{i}"] = f.dense((c, (L + 1) * c), ("gnn_in", "gnn_out"))
        p[f"ffn_gateb_{i}"] = f.zeros(((L + 1) * c,), ("gnn_out",))
        p[f"ffn_out_{i}"] = f.dense((c, c), ("gnn_in", "gnn_out"), scale=0.02)
        p[f"ffn_norm_{i}"] = f.ones((L + 1, c), ("gnn_l", "gnn_out"))
    p["head0"] = f.dense((c, c), ("gnn_in", "gnn_out"))
    p["head0b"] = f.zeros((c,), ("gnn_out",))
    p["head1"] = f.dense((c, 1), ("gnn_in", "gnn_out"))
    return mcommon.split_tree(p)


def _eq_norm(x: torch.Tensor, w: torch.Tensor, l_max: int) -> torch.Tensor:
    """Equivariant RMS norm: per (l, channel) scale by 1/rms over m."""
    outs = []
    for l in range(l_max + 1):
        blk = x[:, l * l:(l + 1) * (l + 1), :]
        rms = torch.sqrt(torch.mean(blk * blk, dim=(1, 2), keepdim=True)
                         + 1e-8)
        outs.append(blk / rms * w[l])
    return torch.cat(outs, dim=1)


def _so2_conv(xr: torch.Tensor, p: dict, i: int, cfg: EqV2Config
              ) -> torch.Tensor:
    """Per-m dense mixing in the edge frame. xr (E, S, C) -> (E, S, C);
    coefficients with |m| > m_max are dropped (eSCN truncation). The
    result is written into a fresh zeros tensor, which no op before it
    saved."""
    e, s, c = xr.shape
    out = torch.zeros_like(xr)
    idx0, _ = _m_indices(cfg.l_max, 0)
    x0 = xr[:, idx0, :].reshape(e, -1)
    out[:, idx0, :] = (x0 @ p[f"so2_m0_{i}"]).reshape(e, len(idx0), c)
    for m in range(1, cfg.m_max + 1):
        pos, neg = _m_indices(cfg.l_max, m)
        xp = xr[:, pos, :].reshape(e, -1)
        xn = xr[:, neg, :].reshape(e, -1)
        wr, wi = f"so2_r{m}_{i}", f"so2_i{m}_{i}"    # read at each product
        out[:, pos, :] = (xp @ p[wr] - xn @ p[wi]).reshape(e, len(pos), c)
        out[:, neg, :] = (xp @ p[wi] + xn @ p[wr]).reshape(e, len(neg), c)
    return out


def _replicated(t: torch.Tensor, axes: tuple) -> torch.Tensor:
    """``t``, which every edge shard on ``axes`` holds whole, read by one
    shard: the op counter records the all-reduce of its partial gradient
    over ``axes`` that the gradient pass makes (``collective``'s
    ``back``). Each read is one such all-reduce, as in the reference's
    compiled step, whose partitioner sums the gradient of each product
    that reads a replicated weight with the sharded edges on its own."""
    return opcost_hooks.collective(t, None, axes, back="all-reduce")


class _ShardReads:
    """An edge shard's weights: each ``[key]`` is one ``_replicated``
    read."""

    def __init__(self, p: dict, axes: tuple):
        self.p, self.axes = p, axes

    def __getitem__(self, key: str) -> torch.Tensor:
        return _replicated(self.p[key], self.axes)


def _edge_messages(h, q, p, i, part, cfg: EqV2Config, n: int):
    """One part of an edge chunk: its attention-weighted messages scattered
    into (N + 1, S, C) and its weights into (N + 1, C), the trash row
    last, on the part's device."""
    s_c, d_c, u_c, r_c, o_c = part
    hd = cfg.channels // cfg.n_heads
    valid = o_c[:, None]
    s_s = torch.clamp(s_c, max=n - 1)
    d_s = torch.clamp(d_c, max=n - 1)
    wig = so3.wigner_d_from_r(so3.rotation_to_z(u_c), cfg.l_max)
    xr = torch.bmm(wig, h[s_s])                       # (e, S, C)
    y = _so2_conv(xr, p, i, cfg)
    gate = F.silu(r_c @ p[f"gate_{i}"] + p[f"gateb_{i}"])
    y = y * gate[:, None, :]
    msg = torch.bmm(wig.transpose(1, 2), y)           # rotate back (D^T)
    k = msg[:, 0, :] @ p[f"attn_k_{i}"]               # (e, heads)
    logit = 8.0 * torch.tanh((q[d_s] + k) / 8.0)
    a = torch.exp(logit) * valid
    msg_h = msg.reshape(-1, cfg.s_dim, cfg.n_heads, hd)
    msg_w = (msg_h * a[:, None, :, None]).reshape(-1, cfg.s_dim,
                                                  cfg.channels)
    return (g.segment_sums(msg_w, d_c, n),
            g.segment_sums(a.repeat_interleave(hd, dim=-1), d_c, n))


def _layer(x, p, i, edges, cfg: EqV2Config, devices=None, coords=None):
    """One eSCN attention block + FFN.

    edges: per-chunk tuples (src, dst, unit, rbf, edge_ok); the Wigner
    matrices are built per chunk. With ``devices`` (the edge shards', at
    mesh coordinates ``coords``), each chunk is split into one part a
    device, each part's messages are computed there, and the partial
    scatters are summed on ``x``'s device (the all-reduce of a
    multi-process run, of the (N + 1)-row sums, as the reference's
    partitioner places it before the trash row is dropped). The op
    counter also records the gradient pass's all-reduces of what each
    part reads whole: the normed features, the queries and each product's
    weight (``_replicated``).
    """
    n = x.shape[0]
    h = _eq_norm(x, p[f"norm_{i}"], cfg.l_max)
    q = h[:, 0, :] @ p[f"attn_q_{i}"]                    # (N, heads)

    num = torch.zeros_like(x)
    den = x.new_zeros((n, cfg.channels))
    mine = {}                           # the layer's operands on a device
    for dev in devices or ():
        if dev not in mine:
            mine[dev] = (h.to(dev), q.to(dev),
                         {k: v.to(dev) for k, v in p.items()
                          if k.endswith(f"_{i}")})
    for chunk in edges:
        if devices is None:
            parts = [(chunk, h, q, p)]
        else:
            parts = [(tuple(a.to(dev) for a in part), *mine[dev])
                     for dev, part in zip(devices, zip(
                         *(a.tensor_split(len(devices)) for a in chunk)))]
        for j, (part, h_d, q_d, p_d) in enumerate(parts):
            if coords is None:
                num_p, den_p = _edge_messages(h_d, q_d, p_d, i, part, cfg, n)
            else:
                axes = cfg.edge_shard_axes
                with opcost_hooks.shard(coords[j]):
                    num_p, den_p = (
                        opcost_hooks.collective(t, "all-reduce", axes)
                        for t in _edge_messages(
                            _replicated(h_d, axes), _replicated(q_d, axes),
                            _ShardReads(p_d, axes), i, part, cfg, n))
            num = num + num_p[:n].to(x.device)
            den = den + den_p[:n].to(x.device)
    # a node no valid edge reaches has den = num = 0 and agg = 0, as in
    # the reference; the where keeps the 1e-9 floor's 1e9 out of its
    # gradient, which an edge masked out (a self loop) into such a node
    # would carry back as inf * 0 = nan
    reached = (den > 0)[:, None, :]
    agg = torch.where(reached, num / torch.clamp(den, min=1e-9)[:, None, :],
                      0.0)
    x = x + agg @ p[f"proj_{i}"]

    h2 = _eq_norm(x, p[f"ffn_norm_{i}"], cfg.l_max)
    gates = torch.sigmoid(h2[:, 0, :] @ p[f"ffn_gate_{i}"]
                          + p[f"ffn_gateb_{i}"])
    gates = gates.reshape(-1, cfg.l_max + 1, cfg.channels)
    lidx = [l for l in range(cfg.l_max + 1) for _ in range(2 * l + 1)]
    u = (h2 @ p[f"ffn_in_{i}"]) * gates[:, lidx, :]
    return x + u @ p[f"ffn_out_{i}"]


def _embed_edges(params, rbf, edge_ok, edge_dst, n: int, cfg: EqV2Config,
                 devices=None, coords=None) -> torch.Tensor:
    """The edge embedding's node sums (N, C). With ``devices`` (at mesh
    coordinates ``coords``) the edges are split into one part a device, as
    the layers split a chunk: the reference's constraint on its one chunk
    reaches the unchunked edge arrays through the reshape, so its
    partitioner shards this sum too (with more chunks it does not, and
    neither does the port)."""
    if devices is None:
        return g.scatter_sum(
            F.silu(rbf @ params["rbf0"] + params["rbf0b"]) * edge_ok[:, None],
            edge_dst, n)
    axes = cfg.edge_shard_axes
    total = None
    for j, (dev, (r, ok, dst)) in enumerate(zip(devices, zip(
            *(a.tensor_split(len(devices)) for a in (rbf, edge_ok,
                                                     edge_dst))))):
        p = _ShardReads({k: params[k].to(dev) for k in ("rbf0", "rbf0b")},
                        axes)
        with opcost_hooks.shard(coords[j]):
            part = opcost_hooks.collective(g.segment_sums(
                F.silu(r.to(dev) @ p["rbf0"] + p["rbf0b"])
                * ok.to(dev)[:, None], dst.to(dev), n), "all-reduce", axes)
        part = part[:n].to(rbf.device)
        total = part if total is None else total + part
    return total


def forward(params, batch: g.GraphBatch, cfg: EqV2Config, *,
            mesh=None) -> torch.Tensor:
    """Returns per-graph energies.

    With ``cfg.edge_shard_axes``, each edge chunk is split over the
    devices of ``mesh`` (a ``launch.mesh.DeviceMesh``) along those axes,
    the reference's sharding constraint on the chunks: each part's
    messages on its own device, the partial scatters summed on the
    parameters' device. With one chunk the edge embedding is split so too
    (``_embed_edges``). Without a mesh, edge shard axes are refused (the
    reference's constraint needs a mesh in context)."""
    devices = coords = None
    if cfg.edge_shard_axes:
        if mesh is None:
            raise ValueError(f"edge_shard_axes {cfg.edge_shard_axes} shard "
                             "the edge chunks over a mesh: pass mesh=")
        coords = mesh.coords(cfg.edge_shard_axes)
        devices = [mesh.device(**c) for c in coords]
    n = batch.node_feat.shape[0]
    e_total = batch.edge_src.shape[0]
    species = g.species_of(batch.node_feat, cfg.n_species)

    x_ext = g.with_pad_row(batch.coords)
    src = torch.clamp(batch.edge_src, max=n)
    dst = torch.clamp(batch.edge_dst, max=n)
    dvec = x_ext[dst] - x_ext[src]
    dist = torch.sqrt(torch.sum(dvec * dvec, -1) + 1e-12)
    # degenerate edges (pads, zero-length self loops) have no frame
    edge_ok = (batch.edge_src < n) & (batch.edge_dst < n) & (dist > 1e-6)
    unit = dvec / torch.clamp(dist, min=1e-9)[:, None]
    centers = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, dtype=dist.dtype,
                             device=dist.device)
    gamma = 1.0 / (centers[1] - centers[0]) ** 2
    rbf = torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)
    n_chunks = max(e_total // min(cfg.edge_chunk, e_total), 1)
    assert e_total % n_chunks == 0, (e_total, n_chunks)
    x0 = params["embed"][species] + _embed_edges(
        params, rbf, edge_ok, batch.edge_dst, n, cfg,
        devices if n_chunks == 1 else None, coords)
    x = torch.cat([x0[:, None, :],
                   x0.new_zeros((n, cfg.s_dim - 1, cfg.channels))], dim=1)

    edges = list(zip(*(a.chunk(n_chunks) for a in
                       (batch.edge_src, batch.edge_dst, unit, rbf, edge_ok))))
    for i in range(cfg.n_layers):
        x = _layer(x, params, i, edges, cfg, devices, coords)

    e_atom = F.silu(x[:, 0, :] @ params["head0"] + params["head0b"])
    e_atom = (e_atom @ params["head1"])[:, 0]
    return g.segment_sum_graphs(e_atom, batch)


def loss_fn(params, batch: g.GraphBatch, targets: torch.Tensor,
            cfg: EqV2Config, *, mesh=None):
    e = forward(params, batch, cfg, mesh=mesh)
    loss = torch.mean((e - targets) ** 2)
    return loss, {"mse": loss}

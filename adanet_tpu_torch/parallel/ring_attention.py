"""Ring attention: exact attention over sequence-sharded inputs.

Port of adanet_tpu/parallel/ring_attention.py (Liu et al., "Ring
Attention with Blockwise Transformers"). The sequence is cut into p
shards; the queries of shard i stay put while the key/value blocks come
round: shard i's own block first, then at ring step s the block of shard
(i - s) mod p, each folded into f32 accumulators with the online
softmax of `_block_attention`, causal masks taken over global
positions. No step holds more than one [B, S/p, H, S/p] block of scores.

The JAX package runs the p shards on p devices under `shard_map` and
rotates the blocks with `ppermute`. The port has two forms, chosen by
the `SequenceMesh`:

- **in one process** (`SequenceMesh(p)`): the p shards run one after
  another on one device, visiting the blocks in the JAX order; the
  counterpart of the JAX tests' 8-device CPU mesh, and on the card all p
  shards share it.
- **across processes** (`SequenceMesh.connect(address, p, rank)`): one
  shard a process, over a gloo process group of the mesh's own (not the
  default group, which stays the Estimator's). Key/value blocks move to
  the next process with a send and a receive posted together, p - 1
  hops and no wasted last hop. Gloo moves CPU tensors only (and NCCL
  refuses two processes on one card), so a CUDA block is staged through
  host memory explicitly; the mesh counts the bytes staged and times the
  hops (`stats`). Every process passes the whole sequence and gets the
  whole output back (each computes its own shard, and the shards'
  outputs are gathered), so the rest of a model runs replicated.

Autograd does not differentiate a send or a receive, and the blockwise
loop would keep every block's probabilities alive for the backward
pass, so both forms are `torch.autograd.Function`s: the forward keeps
q, k, v, the f32 output and each row's log-sum-exp, and the backward
runs the ring again, recomputing each block's probabilities from the
log-sum-exp; across processes the dK/dV accumulators travel with their
key/value block and take one more hop home at the end.

`_NEG_INF` stays the finite -1e30: a fully masked block gives exp(0) = 1
for each masked key, which the next block's correction factor
exp(row_max - new_max) = 0 wipes out; -inf would give NaN there. With
the own block first, every causal row sees its diagonal at step 0. A
block that the causal mask hides entirely changes no accumulator (its
probabilities are exactly 0), so it is skipped.
"""

from __future__ import annotations

import datetime
import math
import time
from typing import Dict

import torch

_NEG_INF = -1e30


class SequenceMesh:
    """The sequence axis of a mesh: `shards` shards, all in this process
    (`group` None), or one a process over `group` (this process holding
    shard `rank`). `shape[axis_name]` is the shard count, as a JAX
    mesh's."""

    def __init__(self, shards: int, axis_name: str = "sp", group=None, rank: int = 0):
        if shards < 1:
            raise ValueError("a sequence mesh needs at least one shard, got %d" % shards)
        self.shards = int(shards)
        self.axis_name = axis_name
        self.group = group
        self.rank = int(rank)
        self._store = None
        self.stats: Dict[str, float] = {"hops": 0, "staged_bytes": 0, "hop_secs": 0.0}

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: self.shards}

    @classmethod
    def connect(cls, address: str, shards: int, rank: int, axis_name: str = "sp", timeout_secs: float = 300.0):
        """One shard a process: joins the gloo group of `shards`
        processes whose store rank 0 serves at `address` ("host:port")."""
        import torch.distributed as dist

        host, port = address.rsplit(":", 1)
        timeout = datetime.timedelta(seconds=timeout_secs)
        store = dist.TCPStore(host, int(port), shards, rank == 0, timeout=timeout)
        group = dist.ProcessGroupGloo(dist.PrefixStore("sequence_mesh", store), rank, shards, timeout)
        mesh = cls(shards, axis_name, group, rank)
        mesh._store = store
        return mesh

    def __deepcopy__(self, memo):
        # A handle on the group (its processes, its store): copies of a
        # module or a config share it.
        return self

    def reset_stats(self) -> None:
        self.stats = {"hops": 0, "staged_bytes": 0, "hop_secs": 0.0}


def _scores(q, k, mask):
    """[B, Sq, H, Sk] f32 scores over the square root of the head size,
    masked with `_NEG_INF` where `mask` ([Sq, Sk], True = keep) is
    False."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) / math.sqrt(d)
    if mask is not None:
        scores = scores.masked_fill(~mask[None, :, None, :], _NEG_INF)
    return scores


def _block_attention(q, k, v, acc, row_max, row_sum, mask):
    """One online-softmax update with a new key/value block (the JAX
    `_block_attention`). q: [B, Sq, H, D]; k, v: [B, Sk, H, D]; acc
    [B, Sq, H, D] f32; row_max, row_sum [B, Sq, H] f32."""
    scores = _scores(q, k, mask)
    new_max = torch.maximum(row_max, scores.amax(dim=-1))
    correction = torch.exp(row_max - new_max)
    probs = torch.exp(scores - new_max[..., None])
    new_sum = row_sum * correction + probs.sum(dim=-1)
    new_acc = acc * correction[..., None] + torch.einsum("bqhk,bkhd->bqhd", probs, v.float())
    return new_acc, new_max, new_sum


def _block_grads(q, k, v, do, lse, delta, mask):
    """One block's share of the gradients, from the probabilities
    recomputed with the row log-sum-exp: (dq, dk, dv) in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    probs = torch.exp(_scores(q, k, mask) - lse[..., None])
    dv = torch.einsum("bqhk,bqhd->bkhd", probs, do)
    dprobs = torch.einsum("bqhd,bkhd->bqhk", do, v.float())
    ds = probs * (dprobs - delta[..., None])
    dq = torch.einsum("bqhk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bqhk,bqhd->bkhd", ds, q.float()) * scale
    return dq, dk, dv


def _mask(causal, shard, src, n, device):
    """The causal mask of queries of `shard` against keys of shard
    `src` ([n, n], over global positions; their offsets cancel out but
    for the shards' order), None when nothing is masked, False when
    everything is."""
    if not causal or src < shard:
        return None
    if src > shard:
        return False
    pos = torch.arange(n, device=device)
    return pos[:, None] >= pos[None, :]


def _init(q):
    b, n, h, d = q.shape
    return (
        torch.zeros((b, n, h, d), dtype=torch.float32, device=q.device),
        torch.full((b, n, h), _NEG_INF, dtype=torch.float32, device=q.device),
        torch.zeros((b, n, h), dtype=torch.float32, device=q.device),
    )


def _shard(x, i, n):
    return x[:, i * n:(i + 1) * n]


class _RingInProcess(torch.autograd.Function):
    """Form (a): the p shards one after another on q's device."""

    @staticmethod
    def forward(ctx, q, k, v, shards, causal):
        n = q.shape[1] // shards
        outs, lses = [], []
        for i in range(shards):
            qi = _shard(q, i, n)
            acc, row_max, row_sum = _init(qi)
            for step in range(shards):
                src = (i - step) % shards
                mask = _mask(causal, i, src, n, q.device)
                if mask is False:
                    continue
                acc, row_max, row_sum = _block_attention(
                    qi, _shard(k, src, n), _shard(v, src, n), acc, row_max, row_sum, mask
                )
            outs.append(acc / row_sum[..., None])
            lses.append(row_max + torch.log(row_sum))
        out = torch.cat(outs, dim=1)
        ctx.save_for_backward(q, k, v, out, torch.cat(lses, dim=1))
        ctx.shards, ctx.causal = shards, causal
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        shards, n = ctx.shards, q.shape[1] // ctx.shards
        do = grad.float()
        delta = (do * out).sum(dim=-1)
        dq = [torch.zeros_like(_shard(out, i, n)) for i in range(shards)]
        dk = [torch.zeros_like(_shard(out, i, n)) for i in range(shards)]
        dv = [torch.zeros_like(_shard(out, i, n)) for i in range(shards)]
        # Step by step, as the ring runs: block src gathers its share
        # from the query shards in the order that its block visits them.
        for step in range(shards):
            for i in range(shards):
                src = (i - step) % shards
                mask = _mask(ctx.causal, i, src, n, q.device)
                if mask is False:
                    continue
                gq, gk, gv = _block_grads(
                    _shard(q, i, n), _shard(k, src, n), _shard(v, src, n), _shard(do, i, n),
                    _shard(lse, i, n), _shard(delta, i, n), mask,
                )
                dq[i] = dq[i] + gq
                dk[src] = dk[src] + gk
                dv[src] = dv[src] + gv
        cat = lambda parts, like: torch.cat(parts, dim=1).to(like.dtype)  # noqa: E731
        return cat(dq, q), cat(dk, k), cat(dv, v), None, None


def _hop(mesh: SequenceMesh, tensors, tag: int):
    """Sends `tensors` to the next shard's process and receives the same
    shapes from the previous one's (posted together), staging CUDA
    tensors through host memory; returns the received tensors on the
    senders' device."""
    t0 = time.perf_counter()
    device = tensors[0].device
    flat = torch.cat([t.reshape(-1) for t in tensors])
    host = flat.cpu() if flat.is_cuda else flat.contiguous()
    received = torch.empty_like(host)
    p = mesh.shards
    sent = mesh.group.send([host], (mesh.rank + 1) % p, tag)
    got = mesh.group.recv([received], (mesh.rank - 1) % p, tag)
    sent.wait()
    got.wait()
    if flat.is_cuda:
        mesh.stats["staged_bytes"] += 2 * host.numel() * host.element_size()
        received = received.to(device)
    mesh.stats["hops"] += 1
    mesh.stats["hop_secs"] += time.perf_counter() - t0
    out, offset = [], 0
    for t in tensors:
        out.append(received[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


def _gather(mesh: SequenceMesh, x):
    """Every process's shard `x` ([B, n, ...]), concatenated along the
    sequence in shard order (staged through host memory for CUDA)."""
    host = x.detach().cpu() if x.is_cuda else x.detach().contiguous()
    parts = [torch.empty_like(host) for _ in range(mesh.shards)]
    mesh.group.allgather([parts], [host]).wait()
    if x.is_cuda:
        mesh.stats["staged_bytes"] += (mesh.shards + 1) * host.numel() * host.element_size()
    return torch.cat(parts, dim=1).to(x.device)


class _RingAcrossProcesses(torch.autograd.Function):
    """Form (b): this process's shard of the whole q, k, v, with the
    key/value blocks rotating through the mesh's group."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal):
        p, r = mesh.shards, mesh.rank
        n = q.shape[1] // p
        qi, kb, vb = _shard(q, r, n), _shard(k, r, n).contiguous(), _shard(v, r, n).contiguous()
        acc, row_max, row_sum = _init(qi)
        for step in range(p):
            src = (r - step) % p
            mask = _mask(causal, r, src, n, q.device)
            if mask is not False:
                acc, row_max, row_sum = _block_attention(qi, kb, vb, acc, row_max, row_sum, mask)
            if step < p - 1:
                kb, vb = _hop(mesh, (kb, vb), step)
        out = acc / row_sum[..., None]
        ctx.save_for_backward(q, k, v, out, row_max + torch.log(row_sum))
        ctx.mesh, ctx.causal = mesh, causal
        return _gather(mesh, out.to(q.dtype))

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        mesh = ctx.mesh
        p, r = mesh.shards, mesh.rank
        n = q.shape[1] // p
        qi = _shard(q, r, n)
        do = _shard(grad, r, n).float()
        delta = (do * out).sum(dim=-1)
        kb, vb = _shard(k, r, n).contiguous(), _shard(v, r, n).contiguous()
        dq = torch.zeros_like(out)
        dkb, dvb = torch.zeros_like(out), torch.zeros_like(out)
        for step in range(p):
            src = (r - step) % p
            mask = _mask(ctx.causal, r, src, n, q.device)
            if mask is not False:
                gq, gk, gv = _block_grads(qi, kb, vb, do, lse, delta, mask)
                dq = dq + gq
                dkb, dvb = dkb + gk, dvb + gv
            if step < p - 1:
                kb, vb, dkb, dvb = _hop(mesh, (kb, vb, dkb, dvb), p + step)
        # The accumulators hold block (r + 1) mod p's gradients: one hop
        # takes them home.
        if p > 1:
            dkb, dvb = _hop(mesh, (dkb, dvb), 2 * p)
        return (_gather(mesh, dq.to(q.dtype)), _gather(mesh, dkb.to(k.dtype)),
                _gather(mesh, dvb.to(v.dtype)), None, None)


def ring_attention(q, k, v, mesh: SequenceMesh, axis_name: str = "sp", causal: bool = False):
    """Exact multi-head attention with the sequence sharded over the
    mesh's `axis_name`.

    Args:
      q, k, v: [batch, seq, heads, head_dim] tensors, the whole sequence
        (in every process of a mesh across processes).
      mesh: the `SequenceMesh` holding `axis_name`.
      causal: apply a causal mask over global positions.

    Returns:
      [batch, seq, heads, head_dim] attention output in q's dtype.
    """
    num_shards = mesh.shape[axis_name]
    seq = q.shape[1]
    if seq % num_shards != 0:
        raise ValueError(
            "Sequence length %d must be divisible by the %r axis size %d." % (seq, axis_name, num_shards)
        )
    if mesh.group is None:
        return _RingInProcess.apply(q, k, v, num_shards, causal)
    return _RingAcrossProcesses.apply(q, k, v, mesh, causal)


def full_attention(q, k, v, causal: bool = False):
    """Single-device reference attention (the correctness oracle)."""
    mask = None
    if causal:
        pos_q = torch.arange(q.shape[1], device=q.device)
        pos_k = torch.arange(k.shape[1], device=q.device)
        mask = pos_q[:, None] >= pos_k[None, :]
    probs = torch.softmax(_scores(q, k, mask), dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", probs, v.float()).to(q.dtype)

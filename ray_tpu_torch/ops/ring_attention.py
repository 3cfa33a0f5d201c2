"""Ring attention: causal attention over a sequence-sharded axis (port of
``ray_tpu/ops/ring_attention.py``).

Q/K/V are sharded over the mesh axis ``sp``: a rank holds
``[B, C, H, D]`` with ``C = T / sp``, its positions
``[idx * C, (idx + 1) * C)``. Each rank attends its Q block to the K/V
block it holds, then passes K/V one step around the ring, so ``sp`` steps
visit every K/V block while a rank only ever holds ``C`` keys. The ring
runs backward: rank ``i`` sends to rank ``i - 1`` and receives from rank
``i + 1`` (the JAX permutation ``[(i, (i - 1) % sp)]``), so at step ``s``
a rank holds K/V block ``(idx + s) % sp``.

Causal masking across blocks: a K/V block ahead of the Q block contributes
nothing (computed, then masked out of the merge), the rank's own block
takes the triangular mask, and blocks behind contribute fully.

Two bodies, one per ``impl``:

* ``ring_flash_attention_local`` (``"fused"``, the default): each step is a
  call of the flash kernels (``ops/flash_attention.py``). The per-block
  results are block-normalised (out_s, lse_s) and merged in log space in
  fp32, which gives the global softmax exactly:
  ``lse = logaddexp_s(lse_s)``, ``out = sum_s exp(lse_s - lse) * out_s``;
  a block ahead of the Q block enters with ``lse_s = -1e30``. The backward
  is a second ring pass: ``flash_dkv`` + ``flash_dq`` against the GLOBAL
  (out, lse) give this block's exact (dq, dk, dv) (``p = exp(s - lse)`` is
  the global probability); a block ahead takes the lse ``+1e30``, so
  ``p = 0`` exactly, and is also multiplied by 0. dQ accumulates in fp32
  on the rank; the fp32 dK/dV accumulators travel with their K/V block and
  take one final step home.
* ``ring_causal_attention_local`` (``"dense"``): the einsum body, with
  fp32 running (max, denominator, accumulator) -- the plain version of the
  fused ring, differentiable through autograd.

What differs from the JAX module, and why:

* The body takes its exchange as an argument (``ring=``), where the JAX
  body names the ``shard_map`` axis: ``GroupRing`` passes blocks between
  the ranks of the ``sp`` process group (NCCL on the card, gloo on the
  CPU), each step's sends and receives in one ``batch_isend_irecv``;
  ``FoldedRing`` runs all ``sp`` positions of a ring in one process, the
  rank axis folded into the batch (``fold_sequence``) and the exchange a
  ``torch.roll`` over it. The arithmetic is the same; in the folded form
  each flash call holds ``sp`` times a rank's batch.
* ``ring_causal_attention`` runs on the caller's local tensors, as the
  port's train step does (``train/train_step.py``): this rank's rows and
  its ``C`` positions. ``batch_axes`` is accepted for the same signature
  and has nothing to do: the rows are already this rank's.
* Blocks are sent and received as contiguous buffers: a block may arrive
  as a strided view (GPT-2's q/k/v are views of the fused qkv product).
* The flash wrappers compute their plain versions on CPU tensors; on CUDA
  they launch the kernels or raise (bf16 only, G1), never fall back.

Kernel launches per ring call on a rank: ``flash_fwd`` ``sp`` times (the
first causal), ``flash_dkv`` and ``flash_dq`` ``sp`` times each. Blocks
ahead of the Q block are computed and masked, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ray_tpu_torch.ops import flash_attention as _fa

_NEG_INF = -1e30


# -- the exchange ----------------------------------------------------------


class GroupRing:
    """The ring over the ranks of ``group`` (the mesh's ``sp`` group):
    ``shift`` sends each tensor to the group's rank ``i - 1`` and receives
    its replacement from rank ``i + 1``, all in one batch of point-to-point
    operations, so no pair of ranks can deadlock on their order."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def index(self, rows: int, device) -> torch.Tensor:
        """This rank's position on the ring, for each of ``rows`` rows."""
        return torch.full((rows,), self.rank, dtype=torch.long,
                          device=device)

    def shift(self, xs, back: bool = False) -> list:
        """Each tensor of ``xs`` one step around the ring (``back``: the
        other way, the adjoint)."""
        if self.size == 1:
            return list(xs)
        step = 1 if back else -1
        to = dist.get_global_rank(self.group, (self.rank + step) % self.size)
        frm = dist.get_global_rank(self.group, (self.rank - step) % self.size)
        sends = [x.contiguous() for x in xs]
        recvs = [torch.empty_like(x) for x in sends]
        ops = [op for tag, (s, r) in enumerate(zip(sends, recvs)) for op in (
            dist.P2POp(dist.isend, s, to, self.group, tag),
            dist.P2POp(dist.irecv, r, frm, self.group, tag))]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recvs


class FoldedRing:
    """All ``size`` positions of a ring in one process: a tensor's rows are
    ``size`` blocks of a rank's rows, rank-major (``fold_sequence``), and
    ``shift`` rolls the blocks, so rank ``i`` gets rank ``i + 1``'s."""

    def __init__(self, size: int):
        self.size = size

    def index(self, rows: int, device) -> torch.Tensor:
        return torch.arange(self.size, device=device).repeat_interleave(
            rows // self.size)

    def shift(self, xs, back: bool = False) -> list:
        step = 1 if back else -1
        return [x.reshape(self.size, -1, *x.shape[1:]).roll(step, 0)
                .reshape(x.shape) for x in xs]


def fold_sequence(x, sp: int):
    """[B, T, ...] -> [sp * B, T / sp, ...]: rank r's positions as rows
    ``r * B`` to ``(r + 1) * B`` (``FoldedRing``'s layout)."""
    b, t = x.shape[:2]
    return (x.reshape(b, sp, t // sp, *x.shape[2:]).transpose(0, 1)
            .reshape(sp * b, t // sp, *x.shape[2:]))


def unfold_sequence(x, sp: int):
    """The inverse of ``fold_sequence``."""
    b, c = x.shape[0] // sp, x.shape[1]
    return (x.reshape(sp, b, c, *x.shape[2:]).transpose(0, 1)
            .reshape(b, sp * c, *x.shape[2:]))


class _Shift(torch.autograd.Function):
    """``ring.shift`` of one tensor (``jax.lax.ppermute``); its adjoint is
    the shift the other way."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring.shift([x])[0]

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.shift([g], back=True)[0], None


def _rows(mask, like):
    """A per-row [R] tensor broadcast against ``like`` ([R, ...])."""
    return mask.reshape(-1, *([1] * (like.dim() - 1)))


# -- the dense body --------------------------------------------------------


def _block_attend(q, k, v, q_chunk_idx, kv_chunk_idx, chunk, scale):
    """Scores of local q against one kv chunk with cross-chunk causality.
    q, k, v: [B, C, H, D]; the chunk indices [B]; returns (the scores' max
    m [B, H, C, 1], exp-sum l [B, H, C, 1], weighted acc [B, C, H, D])."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.float()) * scale
    pos = torch.arange(chunk, device=q.device)
    q_pos = q_chunk_idx[:, None] * chunk + pos
    k_pos = kv_chunk_idx[:, None] * chunk + pos
    mask = (q_pos[:, :, None] >= k_pos[:, None, :])[:, None]  # [B,1,Q,K]
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    # Guard fully-masked rows (kv chunk entirely in the future).
    m_safe = torch.clamp_min(m, _NEG_INF / 2)
    p = torch.where(mask, torch.exp(s - m_safe), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m_safe, l, acc


def ring_causal_attention_local(q, k, v, *, ring,
                                softmax_scale: float | None = None):
    """The dense per-rank body over the exchange ``ring``: q/k/v
    [B, C, H, D] -> out [B, C, H, D] in q.dtype. Differentiable through
    autograd (the exchange's adjoint is the reverse shift)."""
    b, c, h, d = q.shape
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    my_idx = ring.index(b, q.device)
    qf = q.float()
    m = torch.full((b, h, c, 1), _NEG_INF / 2, device=q.device)
    l = torch.zeros((b, h, c, 1), device=q.device)
    acc = torch.zeros((b, c, h, d), device=q.device)
    k_cur, v_cur = k, v
    for i in range(ring.size):
        kv_idx = (my_idx + i) % ring.size
        bm, bl, bacc = _block_attend(qf, k_cur, v_cur, my_idx, kv_idx, c,
                                     scale)
        m_new = torch.maximum(m, bm)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(bm - m_new)
        l = l * alpha + bl * beta
        acc = acc * alpha.transpose(1, 2) + bacc * beta.transpose(1, 2)
        m = m_new
        if i != ring.size - 1:
            k_cur = _Shift.apply(k_cur, ring)
            v_cur = _Shift.apply(v_cur, ring)
    out = acc / l.transpose(1, 2).clamp_min(1e-30)
    return out.to(q.dtype)


# -- the fused body --------------------------------------------------------


def _lse_to_weights(lse):
    """[B, H, C] fp32 -> a [B, C, H, 1] weight exponent, broadcastable
    against [B, C, H, D]."""
    return lse.transpose(1, 2)[..., None]


def _ring_flash_fwd(q, k, v, ring, scale):
    """-> (out [B, C, H, D] in q.dtype, the global lse [B, H, C] fp32)."""
    my_idx = ring.index(q.shape[0], q.device)
    out, lse_r = _fa._flash_fwd_op(q, k, v, scale, True)
    out_r = out.float()
    k_cur, v_cur = k, v
    for i in range(1, ring.size):
        k_cur, v_cur = ring.shift([k_cur, v_cur])
        ahead = (my_idx + i) % ring.size > my_idx
        o_i, lse_i = _fa._flash_fwd_op(q, k_cur, v_cur, scale, False)
        lse_i = torch.where(_rows(ahead, lse_i), _NEG_INF, lse_i)
        lse_new = torch.logaddexp(lse_r, lse_i)
        w_r = torch.exp(_lse_to_weights(lse_r - lse_new))
        w_i = torch.exp(_lse_to_weights(lse_i - lse_new))
        out_r = out_r * w_r + o_i.float() * w_i
        lse_r = lse_new
    return out_r.to(q.dtype), lse_r


def _ring_flash_bwd(q, k, v, out, lse, g, ring, scale):
    """-> (dq, dk, dv), each in its input's dtype."""
    my_idx = ring.index(q.shape[0], q.device)
    delta = _fa.flash_delta(out, g)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_cur, v_cur = k, v
    for i in range(ring.size):
        lse_use, keep = lse, None
        if i:
            k_cur, v_cur, dk_acc, dv_acc = ring.shift(
                [k_cur, v_cur, dk_acc, dv_acc])
            # A block ahead of this Q block contributed nothing forward:
            # the lse +1e30 gives p = exp(s - lse) = 0 exactly, without
            # the overflow (0 * inf = nan) of an unrelated lse.
            ahead = (my_idx + i) % ring.size > my_idx
            lse_use = torch.where(_rows(ahead, lse), -_NEG_INF, lse)
            keep = _rows(~ahead, q).float()
        args = (q, k_cur, v_cur, g, lse_use, delta, scale, i == 0)
        dk_i, dv_i = _fa._flash_dkv_op(*args)
        dq_i = _fa._flash_dq_op(*args)
        if keep is not None:
            dq_i, dk_i, dv_i = (x.float() * keep for x in (dq_i, dk_i, dv_i))
        dq = dq + dq_i.float()
        dk_acc = dk_acc + dk_i.float()
        dv_acc = dv_acc + dv_i.float()
    # One more step returns each accumulator to its K/V block's owner.
    dk_acc, dv_acc = ring.shift([dk_acc, dv_acc])
    return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _RingFlashAttention(torch.autograd.Function):
    """The JAX custom VJP: saves (q, k, v, out, lse); the backward is the
    second ring pass."""

    @staticmethod
    def forward(ctx, q, k, v, ring, scale):
        out, lse = _ring_flash_fwd(q, k, v, ring, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.scale = ring, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_flash_bwd(q, k, v, out, lse, g.contiguous(),
                                     ctx.ring, ctx.scale)
        return dq, dk, dv, None, None


def ring_flash_attention_local(q, k, v, *, ring,
                               softmax_scale: float | None = None):
    """The flash per-rank body over the exchange ``ring`` (differentiable):
    q/k/v [B, C, H, D] -> out [B, C, H, D]."""
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    return _RingFlashAttention.apply(q, k, v, ring, scale)


def ring_causal_attention(q, k, v, mesh, *, axis: str = "sp",
                          softmax_scale: float | None = None,
                          batch_axes=("dp", "fsdp"), impl: str = "fused"):
    """Causal attention of this rank's [B, C, H, D] q/k/v, its positions on
    ``mesh``'s ``axis``, over the ring of that axis's process group.

    ``impl="fused"`` (default) runs the flash kernels on every ring block;
    ``impl="dense"`` the einsum body (materialises [B, H, C, C] scores per
    block)."""
    del batch_axes  # the rows are this rank's already
    local = (ring_flash_attention_local if impl == "fused"
             else ring_causal_attention_local)
    return local(q, k, v, ring=GroupRing(mesh.get_group(axis)),
                 softmax_scale=softmax_scale)

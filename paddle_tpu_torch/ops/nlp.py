"""Structured NLP ops: the linear-chain CRF and its Viterbi decoding,
the CTC loss and its greedy alignment, noise-contrastive estimation,
the hierarchical sigmoid and sampled logits (counterpart of
paddle_tpu/ops/nlp.py).

The Transition parameter is [n+2, n]: row 0 the start scores, row 1 the
stop scores, rows 2.. the [n, n] tag-to-tag scores. Both ops pad the
packed [sum, n] emissions of a LoD batch into [B, T, n] by an index
table made from the offsets (ExecContext.host_table: once a plan, so a
captured block copies nothing), run the dynamic program as a torch loop
over the T padded steps, each step masked past each sequence's length
as the JAX op's lax.scan masks it, and write per-sequence results.
linear_chain_crf's gradient is the generic one: autograd through the
loop of logsumexp.

warpctc runs the CTC forward recursion for the whole batch at once:
the labels padded to the longest extended label (blank l1 blank ... lL
blank), a torch loop over the longest sequence's steps, each sequence
frozen past its own length; its gradient is autograd through the loop
(the JAX op's is the vjp of its scan). ctc_align reads the decoded ids
on the host, since its output's rows depend on them: a block that
holds it stays eager, as one holding edit_distance does. nce and
sample_logits draw their samples from the op's generator
(ExecContext.generator), so a captured step draws what an eager one
does; every gather of a row or an entry is an index whose gradient is
an accumulating index_put_, deterministic in torch's deterministic mode.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_no_grad_op, register_op
from .sequence import _host


def _last_level(lod):
    return lod[-1] if lod else None


def _offsets(ctx, rows):
    off = _last_level(ctx.get_lod("Emission"))
    return [int(v) for v in off] if off is not None else [0, int(rows)]


def _pad_index(off, rows):
    """[B, T] rows of the packed input by (sequence, step); `rows` (one
    past the last) where a step lies past its sequence's end."""
    lens = [off[i + 1] - off[i] for i in range(len(off) - 1)]
    T = max(lens)
    return np.asarray([[off[i] + t if t < n else rows for t in range(T)]
                       for i, n in enumerate(lens)], np.int64)


def _pad_seqs(ctx, x, off):
    """Packed [sum, ...] + offsets -> padded [B, T, ...] (zeros past
    each length), as the JAX _pad_seqs fills."""
    rows = int(x.shape[0])
    idx = ctx.host_table("crf_pad", (tuple(off), rows),
                         lambda: _pad_index(off, rows))
    ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return ext[idx]


def _unpad_rows(ctx, padded, off):
    """Padded [B, T, ...] -> packed [sum, ...] by the offsets."""
    B, T = int(padded.shape[0]), int(padded.shape[1])

    def build():
        return np.asarray([i * T + t for i in range(len(off) - 1)
                           for t in range(off[i + 1] - off[i])], np.int64)
    idx = ctx.host_table("crf_unpad", (tuple(off), T), build)
    return padded.reshape((B * T,) + tuple(padded.shape[2:]))[idx]


def _lengths(ctx, off):
    """(lengths [B] int64, live [B, T] bool: step t < length) on the
    op's device."""
    lens = np.diff(np.asarray(off, np.int64))
    T = int(lens.max())
    key = tuple(off)
    return (ctx.host_table("crf_lens", key, lambda: lens),
            ctx.host_table("crf_live", key,
                           lambda: np.arange(T)[None, :] < lens[:, None]))


@register_op("linear_chain_crf", no_grad_slots=("Label",))
def linear_chain_crf(ctx):
    em = ctx.input("Emission")          # [sum, n] packed
    w = ctx.input("Transition")         # [n+2, n]
    label = ctx.input("Label")          # [sum, 1] int
    off = _offsets(ctx, em.shape[0])
    start, stop, trans = w[0], w[1], w[2:]

    em_p = _pad_seqs(ctx, em, off)                              # [B, T, n]
    lab_p = _pad_seqs(ctx, label.reshape(-1, 1), off)[..., 0].long()
    lens, live = _lengths(ctx, off)
    T = int(em_p.shape[1])

    # log partition: the forward algorithm, frozen past each length
    alpha = start[None] + em_p[:, 0]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + \
            em_p[:, t]
        alpha = torch.where(live[:, t, None], nxt, alpha)
    logz = torch.logsumexp(alpha + stop[None], dim=1)          # [B]

    # the gold path's score
    em_score = torch.where(
        live, em_p.gather(2, lab_p[..., None])[..., 0],
        em_p.new_zeros(())).sum(1)
    first = lab_p[:, 0]
    last = lab_p.gather(1, (lens - 1)[:, None])[:, 0]
    tr_score = torch.where(live[:, 1:], trans[lab_p[:, :-1], lab_p[:, 1:]],
                           em_p.new_zeros(())).sum(1)
    score = start[first] + em_score + tr_score + stop[last]

    ctx.set_output("LogLikelihood", (logz - score).reshape(-1, 1))
    ctx.set_output("EmissionExps", torch.exp(em))
    ctx.set_output("TransitionExps", torch.exp(w))
    ctx.set_output("Alpha", torch.zeros_like(em))


@register_no_grad_op("crf_decoding")
def crf_decoding(ctx):
    """Viterbi: the best tag path of each sequence, packed [sum, 1]
    int32 with the emission's LoD; with Label, 1 where the path's tag
    equals the label's, else 0."""
    em = ctx.input("Emission")
    w = ctx.input("Transition")
    off = _offsets(ctx, em.shape[0])
    start, stop, trans = w[0], w[1], w[2:]
    em_p = _pad_seqs(ctx, em, off)
    _, live = _lengths(ctx, off)
    B, T, n = (int(d) for d in em_p.shape)
    stay = torch.arange(n, device=em.device)[None].expand(B, n)

    # the delta recursion, keeping back-pointers (a step past a length
    # keeps its delta and points each tag at itself)
    delta = start[None] + em_p[:, 0]
    ptrs = []
    for t in range(1, T):
        scores = delta[:, :, None] + trans[None]               # [B, n, n]
        best, ptr = scores.max(dim=1)
        live_t = live[:, t, None]
        delta = torch.where(live_t, best + em_p[:, t], delta)
        ptrs.append(torch.where(live_t, ptr, stay))
    tag = torch.argmax(delta + stop[None], dim=1)              # [B]

    # back along the pointers: the tag at each step, last step first
    path = [tag]
    for p_t in reversed(ptrs):
        tag = p_t.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)                      # [B, T]
    packed = _unpad_rows(ctx, path[..., None], off).to(torch.int32)

    if ctx.has_input("Label"):
        label = ctx.input("Label").reshape(-1, 1).to(torch.int32)
        packed = (packed == label).to(torch.int32)
    ctx.set_output("ViterbiPath", packed)
    ctx.set_lod(ctx.op.output("ViterbiPath")[0], [list(off)])


# the log-space "minus infinity" of the CTC recursion and of
# sample_logits' accidental hits, as the JAX package writes it: an
# infeasible alignment gives a huge finite loss, not inf or NaN
_NEG = -1e30


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) with jnp.logaddexp's derivative, exp(a -
    out) and exp(b - out): where a and b are both the sentinel (an
    infeasible alignment) each gets the whole cotangent, as in JAX,
    where torch's own splits it in halves."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


_logaddexp = _LogAddExp.apply


def _ctc_tables(t_off, l_off, blank):
    """Host tables of a CTC batch: ([B, S] indices into the labels with
    one appended blank (S = 2 * longest label + 1: odd positions the
    labels, the rest and the padding the blank), [B, T] live steps, [B]
    float32 lengths, [B, 2] positions of the last two states, [B] empty
    label)."""
    t_len = np.diff(np.asarray(t_off, np.int64))
    l_len = np.diff(np.asarray(l_off, np.int64))
    blank_row = int(l_off[-1])
    S = 2 * int(l_len.max(initial=0)) + 1
    ext = np.full((len(t_len), S), blank_row, np.int64)
    for b, n in enumerate(l_len):
        ext[b, 1:2 * n:2] = l_off[b] + np.arange(n)
    live = np.arange(int(t_len.max()))[None, :] < t_len[:, None]
    last = np.stack([2 * l_len, np.maximum(2 * l_len - 1, 0)], axis=1)
    return ext, live, t_len.astype(np.float32), last, l_len == 0


@register_op("warpctc", no_grad_slots=("Label",))
def warpctc(ctx):
    """The CTC loss of each sequence, [B, 1]: -log of the summed
    probability of its label's alignments, divided by the sequence's
    length with norm_by_times (as the JAX op does); an empty label's
    loss is -sum_t log p(blank). WarpCTCGrad is zeros, as in JAX: the
    gradient is autograd through the recursion."""
    logits = ctx.input("Logits")         # [sum_t, C] packed
    label = ctx.input("Label")           # [sum_l, 1] packed int
    blank = int(ctx.attr("blank", 0))
    t_lod, l_lod = ctx.get_lod("Logits"), ctx.get_lod("Label")
    if not t_lod or not l_lod:
        raise ValueError("warpctc needs LoD on Logits and Label")
    t_off = [int(v) for v in t_lod[-1]]
    l_off = [int(v) for v in l_lod[-1]]
    key = (tuple(t_off), tuple(l_off), blank)
    ext_idx, live, t_len, last, empty = (
        ctx.host_table(f"ctc_{i}", key,
                       lambda i=i: _ctc_tables(t_off, l_off, blank)[i])
        for i in range(5))

    logp = torch.log_softmax(logits.float(), dim=-1)
    lp = _pad_seqs(ctx, logp, t_off)                       # [B, T, C]
    lab = torch.cat([label.reshape(-1).long(),
                     label.new_full((1,), blank).long()])
    ext = lab[ext_idx]                                     # [B, S]
    B, T, _ = (int(d) for d in lp.shape)
    S = int(ext.shape[1])
    emit = lp.gather(2, ext[:, None, :].expand(B, T, S))   # [B, T, S]
    skip = torch.zeros_like(ext, dtype=torch.bool)
    skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    neg = lp.new_full((), _NEG)
    neg1 = lp.new_full((B, 1), _NEG)
    neg2 = lp.new_full((B, 2), _NEG)

    first = torch.arange(S, device=lp.device) < 2
    a = torch.where(first[None], emit[:, 0], neg)
    for t in range(1, T):
        prev1 = torch.cat([neg1, a[:, :-1]], dim=1)
        prev2 = torch.where(skip, torch.cat([neg2, a[:, :-2]], dim=1), neg)
        nxt = _logaddexp(_logaddexp(a, prev1), prev2) + emit[:, t]
        a = torch.where(live[:, t, None], nxt, a)
    ends = a.gather(1, last)
    loss = -_logaddexp(ends[:, 0], ends[:, 1])
    blank_sum = torch.where(live, lp[..., blank], lp.new_zeros(())).sum(1)
    loss = torch.where(empty, -blank_sum, loss)
    if ctx.attr("norm_by_times", False):
        loss = loss / t_len
    ctx.set_output("Loss", loss.reshape(B, 1))
    ctx.set_output("WarpCTCGrad", torch.zeros_like(logits))


@register_no_grad_op("ctc_align")
def ctc_align(ctx):
    """Greedy CTC decoding of each sequence of ids: repeats merged,
    blanks dropped; int32 [n, 1] with the decoded LoD. An all-empty
    result is one blank row, every sequence's end offset 1, as the JAX
    op writes it."""
    x = ctx.input("Input")
    blank = int(ctx.attr("blank", 0))
    arr = _host(x).reshape(-1)
    lod = ctx.get_lod("Input")
    off = [int(v) for v in lod[-1]] if lod else [0, arr.shape[0]]
    out, new_off = [], [0]
    for s, e in zip(off[:-1], off[1:]):
        seq = arr[s:e]
        keep = (seq != blank)
        keep[1:] &= seq[1:] != seq[:-1]
        out.append(seq[keep])
        new_off.append(new_off[-1] + int(keep.sum()))
    rows = np.concatenate(out) if out else np.zeros(0, arr.dtype)
    if not rows.size:
        rows = np.asarray([blank])
        new_off = [0] + [1] * (len(off) - 1)
    ctx.set_output("Output", torch.from_numpy(
        rows.astype(np.int32).reshape(-1, 1)).to(ctx.device))
    ctx.set_lod("Output", [new_off])


def _softplus(x):
    """log(1 + exp(x)) as jax.nn.softplus computes it (logaddexp(x, 0):
    no linear threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _log_uniform(ctx, shape, n_classes, device):
    """Samples of P(c) = log((c + 2) / (c + 1)) / log(C + 1), the JAX
    ops' transform of a uniform draw: int64 in [0, C)."""
    u = torch.rand(shape, generator=ctx.generator(), device=device)
    neg = (torch.exp(u * float(np.log(n_classes + 1.0))) - 1.0).long()
    return neg.clamp(0, n_classes - 1)


def _log_uniform_logq(c, n_classes):
    """log q(c) of the log-uniform sampler, float32."""
    c = c.float()
    return torch.log(torch.log((c + 2.0) / (c + 1.0)) /
                     float(np.float32(np.log(np.float32(n_classes + 1)))))


@register_op("nce", no_grad_slots=("Label", "SampleWeight",
                                   "CustomDistProbs", "CustomDistAlias",
                                   "CustomDistAliasProbs"))
def nce(ctx):
    """Noise-contrastive estimation: per row, the logistic loss of its
    true classes and of num_neg_samples noise classes drawn from the
    sampler (0 uniform, 1 log-uniform, 2 CustomDistProbs, by inverse
    CDF), each logit less log(k q(class)). SampleLogits [B, nt + k] and
    SampleLabels (int32: the true classes, then the noise) are
    outputs."""
    x = ctx.input("Input")               # [B, D]
    label = ctx.input("Label")           # [B, num_true] int
    w = ctx.input("Weight")              # [C, D]
    bias = ctx.input("Bias")             # [C, 1], [1, C] or [C]
    C = int(ctx.attr("num_total_classes"))
    k = int(ctx.attr("num_neg_samples", 10))
    sampler = int(ctx.attr("sampler", 0))
    B = int(x.shape[0])
    num_true = int(label.shape[1]) if label.ndim > 1 else 1
    label = label.reshape(B, num_true).long()
    dev = x.device
    if sampler == 1:
        neg = _log_uniform(ctx, (B, k), C, dev)
        logq = _log_uniform_logq(neg, C)
        true_q = _log_uniform_logq(label, C)
    elif sampler == 2:
        probs = ctx.input("CustomDistProbs").reshape(-1).float()
        cdf = torch.cumsum(probs, 0)
        u = torch.rand((B * k,), generator=ctx.generator(), device=dev)
        neg = torch.searchsorted(cdf, u * cdf[-1], right=True)
        neg = neg.clamp(max=C - 1).reshape(B, k)
        floor = probs.new_full((), 1e-30)
        logq = torch.log(torch.maximum(probs[neg], floor))
        true_q = torch.log(torch.maximum(probs[label], floor))
    else:
        neg = torch.randint(0, C, (B, k), generator=ctx.generator(),
                            device=dev)
        logq = x.new_full((B, k), -float(np.log(np.float32(C))))
        true_q = x.new_full((B, num_true), -float(np.log(np.float32(C))))
    samples = torch.cat([label, neg], dim=1)                  # [B, nt+k]
    logits = torch.einsum("bd,bsd->bs", x, w[samples])
    if bias is not None:
        logits = logits + bias.reshape(-1)[samples]
    logqk = torch.cat([true_q, logq], dim=1) + float(np.log(np.float32(k)))
    adj = logits - logqk.to(logits.dtype)
    cost = (_softplus(-adj[:, :num_true]).sum(1) +
            _softplus(adj[:, num_true:]).sum(1)).reshape(B, 1)
    sw = ctx.input("SampleWeight")
    if sw is not None:
        cost = cost * sw.reshape(B, 1)
    ctx.set_output("Cost", cost)
    ctx.set_output("SampleLogits", logits)
    ctx.set_output("SampleLabels", samples.to(torch.int32))


@register_op("hierarchical_sigmoid", no_grad_slots=("Label", "PathTable",
                                                    "PathCode"))
def hierarchical_sigmoid(ctx):
    """Hierarchical sigmoid over the complete binary tree of
    num_classes leaves (the reference's SimpleCode): class c is node
    c + C, its path the floor(log2(c + C)) nodes above it, node n's
    weight row (n >> 1) - 1 and its sigmoid target n's low bit; the
    cost sums softplus(z) - bit * z over the path. The path length is
    the code's bit length less one (the JAX op's float32 log2 gives the
    same below 2^24). PreOut holds the logits, 0 past a path's end."""
    x = ctx.input("Input")               # [B, D]
    w = ctx.input("W")                   # [C - 1, D]
    label = ctx.input("Label").reshape(-1).long()
    bias = ctx.input("Bias")             # [1, C - 1] or None
    C = int(ctx.attr("num_classes"))
    B = int(x.shape[0])
    max_len = int(np.ceil(np.log2(max(C, 2))))
    code = label + C                                          # [B]
    pows = ctx.host_table("hsig_pows", max_len,
                          lambda: 2 ** np.arange(1, max_len + 2))
    lengths = (code[:, None] >= pows[None]).sum(1)            # [B]
    js = ctx.host_table("hsig_js", max_len,
                        lambda: np.arange(1, max_len + 1))
    shift = lengths[:, None] - js[None]                       # [B, L]
    valid = shift >= 0
    node = torch.where(valid, code[:, None] >> shift.clamp(min=0),
                       torch.ones_like(shift))
    bit = (node & 1).to(x.dtype)
    parent = torch.where(valid, (node >> 1) - 1, torch.zeros_like(node))
    logit = torch.einsum("bd,bld->bl", x, w[parent])
    if bias is not None:
        logit = logit + bias.reshape(-1)[parent]
    ce = _softplus(logit) - bit * logit
    cost = torch.where(valid, ce, ce.new_zeros(())).sum(1).reshape(B, 1)
    ctx.set_output("Out", cost)
    ctx.set_output("PreOut", logit)


@register_op("sample_logits",
             no_grad_slots=("Labels", "CustomizedSamples",
                            "CustomizedProbabilities"))
def sample_logits(ctx):
    """Sampled softmax's logits: Logits gathered at the true labels and
    the samples (CustomizedSamples, else num_samples log-uniform draws a
    row), less log q; with remove_accidental_hits a sample equal to one
    of its row's labels gets -1e30 added. SampledLabels are 0 ..
    num_true - 1 (the true classes come first)."""
    logits = ctx.input("Logits")         # [B, C]
    labels = ctx.input("Labels").long()  # [B, num_true]
    B, C = (int(d) for d in logits.shape)
    num_true = int(labels.shape[1])
    k = int(ctx.attr("num_samples", 10))
    if ctx.has_input("CustomizedSamples"):
        samples = ctx.input("CustomizedSamples").long()
        probs = ctx.input("CustomizedProbabilities")
    else:
        neg = _log_uniform(ctx, (B, k), C, logits.device)
        samples = torch.cat([labels, neg], dim=1)
        s = samples.float()
        probs = torch.log((s + 2.0) / (s + 1.0)) / \
            float(np.float32(np.log(np.float32(C + 1))))
    S = int(samples.shape[1])
    rows = ctx.host_table("sample_rows", (B, C, S),
                          lambda: np.arange(B)[:, None] * C)
    sampled = logits.reshape(-1)[rows + samples]
    sampled = sampled - torch.log(torch.maximum(
        probs, probs.new_full((), 1e-30))).to(sampled.dtype)
    if ctx.attr("remove_accidental_hits", True):
        hit = (samples[:, None, :] == labels[:, :, None]).any(1)
        hit[:, :num_true] = False
        sampled = torch.where(hit, sampled + _NEG, sampled)
    ctx.set_output("SampledLogits", sampled)
    ctx.set_output("Samples", samples.to(torch.int32))
    ctx.set_output("Probabilities", probs)
    ctx.set_output("SampledLabels", ctx.host_table(
        "sample_labels", (B, num_true),
        lambda: np.broadcast_to(np.arange(num_true, dtype=np.int32),
                                (B, num_true)).copy()))

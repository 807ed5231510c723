"""sign, py_func and py_func_grad (a Python callable run as an op),
chunk_eval, fsp and the int8 inference ops quantize, dequantize and
requantize (counterpart of paddle_tpu/ops/misc.py's sign, py_func,
py_func_grad, chunk_eval, fsp, quantize, dequantize and requantize).

The callable gets host (numpy) copies of its inputs, and its results go
back to the op's device. A host copy cannot run on the meta device nor
inside a CUDA graph, so the engine's capture rule keeps a block holding
py_func eager (its reason: the op type), as it keeps `while`.
chunk_eval counts chunks on host copies of its inputs (their number
depends on the values), so its block stays eager too.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.registry import INPUT_WRITES, register_no_grad_op, register_op
from ..core.scope import tensor_to_numpy
from .quantize import div_scalar


@register_op("sign")
def sign(ctx):
    """-1, 0 or 1 elementwise (L1Decay's term); its gradient is zero."""
    ctx.set_output("Out", torch.sign(ctx.input("X")))


def _host(ctx, v):
    if ctx.device.type == "meta":
        raise NotImplementedError(
            f"{ctx.op.type} runs a Python callable on host copies: it "
            f"runs eagerly only")
    return tensor_to_numpy(v)


def _listed(out):
    return out if isinstance(out, (list, tuple)) else [out]


def _to_device(ctx, v):
    return torch.as_tensor(np.asarray(v)).to(ctx.device)


@register_no_grad_op("py_func")
def py_func(ctx):
    from ..layers.control_flow import py_func_registry
    fn = py_func_registry[ctx.attr("forward_callable_id")]
    outs = _listed(fn(*[_host(ctx, v) for v in ctx.inputs("X")]))
    for n, v in zip(ctx.op.output("Out"), outs):
        ctx.env[n] = _to_device(ctx, v)


@register_no_grad_op("py_func_grad")
def py_func_grad(ctx):
    """The registered backward callable on (inputs, outputs, output
    gradients), less the names in skip_vars_in_backward_input; with no
    backward callable each input's gradient is zeros of that input's
    shape."""
    from ..layers.control_flow import py_func_registry
    bid = ctx.attr("backward_callable_id", -1)
    if bid < 0:
        for in_name, g_name in zip(ctx.op.input("X"),
                                   ctx.op.output("X@GRAD")):
            if g_name:
                ctx.env[g_name] = torch.zeros_like(ctx.env[in_name])
        return
    skip = set(ctx.attr("skip_vars_in_backward_input", []) or [])
    args = [_host(ctx, ctx.env[n]) for slot in ("X", "Out")
            for n in ctx.op.input(slot) if n not in skip]
    args += [_host(ctx, ctx.env[n]) for n in ctx.op.input("Out@GRAD")]
    grads = _listed(py_func_registry[bid](*args))
    for n, g in zip(ctx.op.output("X@GRAD"), grads):
        if n:
            ctx.env[n] = _to_device(ctx, g)


_CHUNK_TAGS = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


def _chunks(seq, scheme, num_chunk_types, excluded):
    """The (type, start, end) chunks of one sequence of tag ids: tag id
    t is chunk type t // n_tags with tag t % n_tags of the scheme (IOB:
    B=0 I=1; IOE: I=0 E=1; IOBES: B=0 I=1 E=2 S=3; plain: one tag), and
    num_chunk_types * n_tags is the outside tag."""
    n_tags = _CHUNK_TAGS[scheme]
    out, start, cur = [], None, None
    for i, t in enumerate(int(v) for v in seq):
        if t == num_chunk_types * n_tags:          # outside
            if start is not None:
                out.append((cur, start, i))
                start = None
            continue
        ctype, tag = t // n_tags, t % n_tags
        if scheme == "plain":
            begin = True
        elif scheme == "IOB":
            begin = tag == 0
        elif scheme == "IOE":
            begin = start is None or ctype != cur
        else:
            begin = tag in (0, 3)
        if begin or ctype != cur:
            if start is not None:
                out.append((cur, start, i))
            start, cur = i, ctype
        if (scheme == "IOE" and tag == 1) or \
                (scheme == "IOBES" and tag in (2, 3)):
            out.append((cur, start, i + 1))
            start = None
    if start is not None:
        out.append((cur, start, len(seq)))
    return {c for c in out if c[0] not in excluded}


@register_no_grad_op("chunk_eval")
def chunk_eval(ctx):
    """Chunk precision, recall and F1 of Inference against Label over
    the sequences of their LoD (one sequence without), and the counts:
    float32 and int32 scalars. The chunks are decoded on the host."""
    inf = _host(ctx, ctx.input("Inference")).reshape(-1)
    lab = _host(ctx, ctx.input("Label")).reshape(-1)
    n_types = int(ctx.attr("num_chunk_types"))
    scheme = ctx.attr("chunk_scheme", "IOB")
    excluded = set(ctx.attr("excluded_chunk_types", []) or [])
    lod = ctx.get_lod("Inference") or ctx.get_lod("Label")
    off = [int(v) for v in lod[-1]] if lod else [0, inf.shape[0]]
    n_inf = n_lab = n_correct = 0
    for s, e in zip(off[:-1], off[1:]):
        ci = _chunks(inf[s:e], scheme, n_types, excluded)
        cl = _chunks(lab[s:e], scheme, n_types, excluded)
        n_inf += len(ci)
        n_lab += len(cl)
        n_correct += len(ci & cl)
    p = n_correct / n_inf if n_inf else 0.0
    r = n_correct / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    for slot, v, dt in (("Precision", p, torch.float32),
                        ("Recall", r, torch.float32),
                        ("F1-Score", f1, torch.float32),
                        ("NumInferChunks", n_inf, torch.int32),
                        ("NumLabelChunks", n_lab, torch.int32),
                        ("NumCorrectChunks", n_correct, torch.int32)):
        ctx.set_output(slot, torch.tensor(v, dtype=dt).to(ctx.device))


@register_op("fsp")
def fsp(ctx):
    """The FSP matrix of distillation: Out[n, i, j] = sum over h, w of
    X[n, i, h, w] * Y[n, j, h, w], over H * W."""
    x, y = ctx.input("X"), ctx.input("Y")
    h, w = x.shape[2], x.shape[3]
    ctx.set_output("Out", div_scalar(torch.einsum("nihw,njhw->nij", x, y),
                                     float(h * w)))


def _int8(v):
    """Round half to even, clip to [-128, 127], int8."""
    return torch.clamp(torch.round(v), -128, 127).to(torch.int8)


@register_no_grad_op("quantize")
def quantize_int8(ctx):
    """Output = int8(round(Input * Scale))."""
    ctx.set_output("Output", _int8(ctx.input("Input") *
                                   ctx.attr("Scale", 1.0)))


@register_no_grad_op("dequantize")
def dequantize_int8(ctx):
    ctx.set_output("Output", div_scalar(
        ctx.input("Input").to(torch.float32), ctx.attr("Scale", 1.0)))


@register_no_grad_op("requantize")
def requantize_int8(ctx):
    """int8 from one scale to another: round(Input / Scale_in *
    Scale_out)."""
    x = ctx.input("Input").to(torch.float32)
    ctx.set_output("Output", _int8(div_scalar(x, ctx.attr("Scale_in", 1.0))
                                   * ctx.attr("Scale_out", 1.0)))


# ---------------------------------------------------------------------------
# slice 26: misc's user-path ops
# ---------------------------------------------------------------------------

def _eager_only(ctx):
    """Refuse the meta device: the op reads values or files on the host,
    so the engine's capture rule keeps its block eager (reason: the op
    type)."""
    if ctx.device.type == "meta":
        raise NotImplementedError(
            f"{ctx.op.type} reads values or files on the host: it runs "
            f"eagerly only")


def _to(ctx, a):
    """A host array on the op's device (in an eager block only)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)


@register_op("pad_constant_like", no_grad_slots=("X",))
def pad_constant_like(ctx):
    """Y padded at the end of each dim up to X's shape with pad_value;
    the gradient reaches Y only."""
    x, y = ctx.input("X"), ctx.input("Y")
    pads = []
    for xs, ys in zip(reversed(x.shape), reversed(y.shape)):
        pads += [0, int(xs) - int(ys)]
    ctx.set_output("Out", torch.nn.functional.pad(
        y, pads, value=float(ctx.attr("pad_value", 0.0))))


@register_no_grad_op("lod_reset")
def lod_reset(ctx):
    """Out is X with the LoD of Y (its LoD, else its values as offsets:
    a host read) or of target_lod; append_lod keeps X's levels above the
    new one (lod_append)."""
    ctx.set_output("Out", ctx.input("X"))
    prefix = list(ctx.get_lod("X")) if ctx.attr("append_lod", False) \
        else []
    if ctx.has_input("Y"):
        ylod = ctx.get_lod("Y")
        if ylod:
            ctx.set_lod("Out", prefix + list(ylod))
        else:
            _eager_only(ctx)
            offs = tensor_to_numpy(ctx.input("Y")).reshape(-1)
            ctx.set_lod("Out", prefix + [[int(v) for v in offs]])
        return
    tl = [int(v) for v in ctx.attr("target_lod", []) or []]
    if tl:
        ctx.set_lod("Out", prefix + [tl])


@register_op("conv_shift")
def conv_shift(ctx):
    """Circular correlation: Out[b, i] = sum over j of
    X[b, (i + j - (N-1)/2) mod M] * Y[b, j]."""
    x, y = ctx.input("X"), ctx.input("Y")        # [B, M], [B, N]
    m, n = x.shape[1], y.shape[1]
    half = (n - 1) // 2
    idx = ctx.host_table("conv_shift", (m, n), lambda: (
        (np.arange(m)[:, None] + np.arange(-half, n - half)[None, :]) % m
    ).astype(np.int64))
    ctx.set_output("Out", torch.einsum("bmn,bn->bm", x[:, idx], y))


@register_op("cvm", no_grad_slots=("CVM",))
def cvm(ctx):
    """The click-value model's feature adjust: use_cvm log-transforms
    the first two columns (show, click), else drops them."""
    x = ctx.input("X")
    if ctx.attr("use_cvm", True):
        head = torch.log(torch.clamp(x[:, :2], min=0.0) + 1.0)
        ctx.set_output("Y", torch.cat([head, x[:, 2:]], dim=1))
    else:
        ctx.set_output("Y", x[:, 2:])


@register_op("modified_huber_loss", no_grad_slots=("Y",))
def modified_huber_loss(ctx):
    """y in {0, 1} taken to {-1, 1}; with p = x * y the loss is
    max(0, 1 - p)^2 where p >= -1, else -4 p (IntermediateVal is p)."""
    x = ctx.input("X")
    y = ctx.input("Y").to(x.dtype) * 2.0 - 1.0
    prod = x * y
    loss = torch.where(prod >= -1.0,
                       torch.square(torch.clamp(1.0 - prod, min=0.0)),
                       -4.0 * prod)
    ctx.set_output("IntermediateVal", prod)
    ctx.set_output("Out", loss)


def _bce(logit, t):
    return torch.clamp(logit, min=0) - logit * t + \
        torch.log1p(torch.exp(-torch.abs(logit)))


@register_op("teacher_student_sigmoid_loss", no_grad_slots=("Label",))
def teacher_student_sigmoid_loss(ctx):
    """The click cross entropy plus the teacher score's: a label of -2
    is z=0 without a teacher, -1 z=1 without, [0, 1) z=0 with teacher
    score label, [1, 2) z=1 with score label - 1."""
    x = ctx.input("X").reshape(-1)
    label = ctx.input("Label").to(x.dtype).reshape(-1)
    z = torch.where(label < 0, label + 2.0,
                    (label >= 1.0).to(x.dtype))
    zprime = torch.where(label < 1.0, label, label - 1.0)
    loss = _bce(x, z) + torch.where(label >= 0, _bce(x, zprime),
                                    torch.zeros_like(x))
    ctx.set_output("Y", loss.reshape(-1, 1))


@register_op("center_loss",
             no_grad_slots=("Label", "Centers", "CenterUpdateRate"))
def center_loss(ctx):
    """Loss = |x - c_y|^2 / 2 a row; with need_update, CentersOut moves
    each center toward its rows: c_j - alpha * sum over y_i = j of
    (c_j - x_i) / (1 + count_j). SampleCenterDiff is x - c_y."""
    x = ctx.input("X")                           # [N, D]
    label = ctx.input("Label").reshape(-1).long()
    centers = ctx.input("Centers")               # [C, D]
    alpha = ctx.input("CenterUpdateRate").reshape(())
    diff = x - centers[label]
    ctx.set_output("SampleCenterDiff", diff)
    ctx.set_output("Loss", 0.5 * torch.sum(torch.square(diff), dim=1,
                                           keepdim=True))
    if not ctx.attr("need_update", True):
        ctx.set_output("CentersOut", centers)
        return
    cnt = x.new_zeros(centers.shape[0]).index_add(
        0, label, x.new_ones(label.shape[0]))
    delta = torch.zeros_like(centers).index_add(0, label, -diff)
    ctx.set_output("CentersOut",
                   centers - alpha * delta / (1.0 + cnt)[:, None])


@register_op("spectral_norm", no_grad_slots=("U", "V"))
def spectral_norm(ctx):
    """Weight over its largest singular value, estimated by power_iters
    steps of power iteration from U and V. The advanced U and V are
    written back to their (persistable) vars, as the reference's kernel
    updates them in place, so the estimate converges across steps and a
    captured replay advances them as an eager run does."""
    w = ctx.input("Weight")
    u0, v0 = ctx.input("U"), ctx.input("V")
    u, v = u0.reshape(-1), v0.reshape(-1)
    dim = int(ctx.attr("dim", 0))
    eps = float(ctx.attr("eps", 1e-12))
    perm = [dim] + [i for i in range(w.dim()) if i != dim]
    wm = w.permute(perm).reshape(w.shape[dim], -1)

    def l2(a):
        return a / (torch.linalg.vector_norm(a) + eps)

    wd = wm.detach()
    for _ in range(max(int(ctx.attr("power_iters", 1)), 0)):
        v = l2(wd.t() @ u)
        u = l2(wd @ v)
    u, v = u.detach(), v.detach()
    ctx.set_output("Out", w / (u @ wm @ v))
    ctx.env[ctx.op.input("U")[0]] = u.reshape(u0.shape)
    ctx.env[ctx.op.input("V")[0]] = v.reshape(v0.shape)


INPUT_WRITES["spectral_norm"] = ("U", "V")


@register_op("similarity_focus", no_grad_slots=())
def similarity_focus(ctx):
    """For each channel in `indexes` (axis 1) of each image, the greedy
    maxima of its [A, B] slice that share no row or column (min(A, B)
    of them, the first maximum in row-major order each time) light up
    their rows and columns; the union, across every channel, as 0/1 in
    X's dtype."""
    x = ctx.input("X")                           # [N, C, A, B]
    if int(ctx.attr("axis", 1)) != 1:
        raise NotImplementedError("similarity_focus: axis=1 only, as in "
                                  "the JAX op")
    idx = [int(i) for i in ctx.attr("indexes")]
    n, c, a, b = x.shape
    sl = x[:, idx]                               # [N, I, A, B]
    rows = torch.zeros(sl.shape[:2] + (a,), dtype=torch.bool,
                       device=x.device)
    cols = torch.zeros(sl.shape[:2] + (b,), dtype=torch.bool,
                       device=x.device)
    neg = torch.full((), -float("inf"), dtype=x.dtype, device=x.device)
    for _ in range(min(a, b)):
        used = rows[..., :, None] | cols[..., None, :]
        k = torch.argmax(torch.where(used, neg, sl).flatten(2), dim=2)
        rows = rows.scatter(2, (k // b)[..., None], True)
        cols = cols.scatter(2, (k % b)[..., None], True)
    mask = (rows[..., :, None] | cols[..., None, :]).any(dim=1)
    ctx.set_output("Out", mask[:, None].expand(n, c, a, b).to(x.dtype))


@register_op("row_conv")
def row_conv(ctx):
    """Lookahead convolution over time: out[t] = sum over j < k of
    Filter[j] * X[t + j], zero past each sequence's end. X is [T, D]
    with a LoD (one sequence without) or batched [B, T, D]."""
    x, w = ctx.input("X"), ctx.input("Filter")   # w [k, D]
    k = w.shape[0]
    if x.dim() == 3:
        xp = torch.nn.functional.pad(x, (0, 0, 0, k - 1))
        t = x.shape[1]
        out = xp[:, 0:t] * w[0]
        for j in range(1, k):
            out = out + xp[:, j:j + t] * w[j]
        ctx.set_output("Out", out)
        return
    lod = ctx.get_lod("X")
    off = [int(v) for v in lod[0]] if lod else [0, x.shape[0]]
    rows = x.shape[0]

    def table():
        """[k, rows]: the row tap j of each row reads, `rows` (a zero
        row) past its sequence's end."""
        src = np.full((k, rows), rows, np.int64)
        for s, e in zip(off[:-1], off[1:]):
            for j in range(k):
                src[j, s:max(e - j, s)] = np.arange(s + j, max(e, s + j))
        return src

    src = ctx.host_table("row_conv", (tuple(off), rows, k), table)
    xz = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
    out = xz[src[0]] * w[0]
    for j in range(1, k):
        out = out + xz[src[j]] * w[j]
    ctx.set_output("Out", out)
    if lod:
        ctx.set_lod("Out", lod)


@register_op("unpool", no_grad_slots=("Indices",))
def unpool(ctx):
    """Max-unpooling: each value of X lands (added) at its flat index
    of Indices in an [(H-1)*s - 2p + k]-sized map, zeros elsewhere."""
    x = ctx.input("X")                           # [N, C, H, W]
    idx = ctx.input("Indices").long()
    ks = ctx.attr("ksize")
    st = ctx.attr("strides", [1, 1])
    pd = ctx.attr("paddings", [0, 0])
    n, c, h, w = x.shape
    oh = (h - 1) * st[0] - 2 * pd[0] + ks[0]
    ow = (w - 1) * st[1] - 2 * pd[1] + ks[1]
    out = x.new_zeros((n, c, oh * ow)).scatter_add(
        2, idx.reshape(n, c, -1), x.reshape(n, c, -1))
    ctx.set_output("Out", out.reshape(n, c, oh, ow))


@register_op("max_pool3d_with_index")
def max_pool3d_with_index(ctx):
    """3-D max pooling with Mask, each maximum's flat d*H*W + h*W + w
    index in the unpadded volume (int32; the first maximum of a window
    in its row-major order). adaptive takes ksize as the output bins:
    bin i of a size-S dim covers [floor(i*S/n), ceil((i+1)*S/n))."""
    x = ctx.input("X")                           # [N, C, D, H, W]
    ks = [int(v) for v in ctx.attr("ksize")]
    st = [int(v) for v in ctx.attr("strides", [1, 1, 1])]
    pd = [int(v) for v in ctx.attr("paddings", [0, 0, 0])]
    if ctx.attr("global_pooling", False):
        ks, pd = list(x.shape[2:]), [0, 0, 0]
    d, h, w = x.shape[2:]
    neg = torch.finfo(x.dtype).min
    if ctx.attr("adaptive", False):
        v, m = _adaptive_max3d(ctx, x, ks, neg)
    else:
        xp = torch.nn.functional.pad(
            x, (pd[2], pd[2], pd[1], pd[1], pd[0], pd[0]), value=neg)

        def lin():
            dp, hp, wp = (d + 2 * pd[0], h + 2 * pd[1], w + 2 * pd[2])
            return ((np.arange(dp)[:, None, None] - pd[0]) * (h * w) +
                    (np.arange(hp)[None, :, None] - pd[1]) * w +
                    (np.arange(wp)[None, None, :] - pd[2])
                    ).astype(np.int64)

        lin_t = ctx.host_table("pool3d_index", (d, h, w, tuple(pd)), lin)

        def windows(t, first):
            for i in range(3):
                t = t.unfold(first + i, ks[i], st[i])
            return t.flatten(-3)

        xw = windows(xp, 2)                      # [N, C, od, oh, ow, K]
        a = torch.argmax(xw, dim=-1, keepdim=True)
        v = torch.take_along_dim(xw, a, dim=-1)[..., 0]
        lw = windows(lin_t, 0)                   # [od, oh, ow, K]
        m = torch.take_along_dim(lw.expand(xw.shape), a, dim=-1)[..., 0]
    ctx.set_output("Out", v)
    ctx.set_output("Mask", m.to(torch.int32))


def _adaptive_max3d(ctx, x, bins, neg):
    n, c, d, h, w = x.shape
    od, oh, ow = bins

    def sel(nb, size):
        i = np.arange(nb)
        starts = (i * size) // nb
        ends = -((-(i + 1) * size) // nb)
        j = np.arange(size)
        return (j[None, :] >= starts[:, None]) & (j[None, :] < ends[:, None])

    def mask():
        return (sel(od, d)[:, None, None, :, None, None] &
                sel(oh, h)[None, :, None, None, :, None] &
                sel(ow, w)[None, None, :, None, None, :]).reshape(
                    od, oh, ow, d * h * w)

    m = ctx.host_table("adaptive_pool3d", (tuple(bins), d, h, w), mask)
    vals = torch.where(m, x.reshape(n, c, 1, 1, 1, d * h * w),
                       torch.full((), neg, dtype=x.dtype, device=x.device))
    a = torch.argmax(vals, dim=-1, keepdim=True)
    return torch.take_along_dim(vals, a, dim=-1)[..., 0], a[..., 0]


@register_op("affine_grid", no_grad_slots=("OutputShape",))
def affine_grid(ctx):
    """Theta [N, 2, 3] to the sampling grid [N, H, W, 2] of an
    [N, C, H, W] output: Theta applied to (x, y, 1) over linspace(-1, 1)
    in each dim. A tensor OutputShape is read on the host, so its block
    runs eagerly."""
    theta = ctx.input("Theta")
    if ctx.has_input("OutputShape"):
        _eager_only(ctx)
        shape = tensor_to_numpy(ctx.input("OutputShape")).reshape(-1)
    else:
        shape = ctx.attr("output_shape")
    _, _, h, w = [int(v) for v in shape]

    def base():
        xg, yg = np.meshgrid(np.linspace(-1.0, 1.0, w, dtype=np.float32),
                             np.linspace(-1.0, 1.0, h, dtype=np.float32))
        return np.stack([xg, yg, np.ones_like(xg)], axis=-1)

    grid = ctx.host_table("affine_grid", (h, w), base).to(theta.dtype)
    ctx.set_output("Output", torch.einsum("hwk,njk->nhwj", grid, theta))


def _tap_gather(flat, yi, xi, h, w):
    """flat [N, G, C, h*w]; yi, xi [N, G, ...] float corner coordinates:
    the values there [N, G, C, ...], zero outside the map."""
    inb = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).to(flat.dtype)
    idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
    n, g, c = flat.shape[:3]
    got = torch.gather(flat, 3, idx.reshape(n, g, 1, -1).expand(
        n, g, c, idx[0, 0].numel()))
    return got.reshape((n, g, c) + tuple(yi.shape[2:])) * inb[:, :, None]


def _bilinear_zero(flat, ys, xs, h, w):
    """Bilinear samples at (ys, xs) [N, G, ...] with zeros outside."""
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[:, :, None], (xs - x0)[:, :, None]
    return (_tap_gather(flat, y0, x0, h, w) * (1 - wy) * (1 - wx) +
            _tap_gather(flat, y0, x0 + 1, h, w) * (1 - wy) * wx +
            _tap_gather(flat, y0 + 1, x0, h, w) * wy * (1 - wx) +
            _tap_gather(flat, y0 + 1, x0 + 1, h, w) * wy * wx)


@register_op("grid_sampler")
def grid_sampler(ctx):
    """Bilinear sampling of X [N, C, Hi, Wi] at Grid [N, H, W, 2]
    ((x, y) in [-1, 1], mapped to [0, size - 1]); taps outside the map
    read zero."""
    x, grid = ctx.input("X"), ctx.input("Grid")
    n, c, hi, wi = x.shape
    gx = (grid[..., 0] + 1.0) / 2.0 * (wi - 1)
    gy = (grid[..., 1] + 1.0) / 2.0 * (hi - 1)
    out = _bilinear_zero(x.reshape(n, 1, c, hi * wi), gy[:, None],
                         gx[:, None], hi, wi)
    ctx.set_output("Output", out[:, 0])


@register_op("deformable_conv", no_grad_slots=("Mask",))
def deformable_conv(ctx):
    """Deformable convolution v2: each output position's kernel tap
    samples Input bilinearly (zeros outside) at its place plus a learned
    offset (Offset read as [N, dg, kh, kw, 2 (y, x), Ho, Wo]), scaled by
    Mask, then the grouped contraction with Filter. As in the JAX op,
    Mask gets no gradient."""
    x = ctx.input("Input")                       # [N, Cin, H, W]
    offset, mask = ctx.input("Offset"), ctx.input("Mask")
    w = ctx.input("Filter")                      # [Cout, Cin/g, kh, kw]
    st = ctx.attr("strides", [1, 1])
    pd = ctx.attr("paddings", [0, 0])
    dl = ctx.attr("dilations", [1, 1])
    groups = ctx.attr("groups", 1) or 1
    dg = ctx.attr("deformable_groups", 1) or 1
    n, cin, h, wd = x.shape
    cout, _, kh, kw = w.shape
    ho = (h + 2 * pd[0] - (dl[0] * (kh - 1) + 1)) // st[0] + 1
    wo = (wd + 2 * pd[1] - (dl[1] * (kw - 1) + 1)) // st[1] + 1
    off = offset.reshape(n, dg, kh, kw, 2, ho, wo)
    mk = mask.reshape(n, dg, kh, kw, ho, wo)
    dev, dt = x.device, x.dtype
    by = (torch.arange(ho, device=dev) * st[0] - pd[0]).to(dt)
    bx = (torch.arange(wo, device=dev) * st[1] - pd[1]).to(dt)
    ky = (torch.arange(kh, device=dev) * dl[0]).to(dt)
    kx = (torch.arange(kw, device=dev) * dl[1]).to(dt)
    ys = (by[None, None, :, None] + ky[:, None, None, None]) + \
        off[:, :, :, :, 0]
    xs = (bx[None, None, None, :] + kx[None, :, None, None]) + \
        off[:, :, :, :, 1]
    cpg = cin // dg
    cols = _bilinear_zero(x.reshape(n, dg, cpg, h * wd), ys, xs, h, wd) \
        * mk[:, :, None]                         # [N, dg, cpg, kh, kw, Ho, Wo]
    cols = cols.reshape(n, cin, kh, kw, ho, wo)
    cg, og = cin // groups, cout // groups
    out = torch.cat([torch.einsum("ncklhw,ockl->nohw",
                                  cols[:, g * cg:(g + 1) * cg],
                                  w[g * og:(g + 1) * og, :cg])
                     for g in range(groups)], dim=1)
    ctx.set_output("Output", out)


@register_op("deformable_psroi_pooling", no_grad_slots=("ROIs",))
def deformable_psroi_pooling(ctx):
    """Deformable position-sensitive RoI pooling: each bin of each RoI
    (ROIs [R, 4] with a LoD over the images) averages
    sample_per_part^2 bilinear samples, shifted by the bin's part of
    Trans [R, 2 (x, y), part_h, part_w] times trans_std and the RoI's
    size, from its group's channels. TopCount is ones."""
    from .detection import _bilinear, _channels_last, _roi_images
    x, rois = ctx.input("Input"), ctx.input("ROIs")
    trans = ctx.input("Trans")
    ss = float(ctx.attr("spatial_scale", 1.0))
    out_dim = int(ctx.attr("output_dim"))
    gh, gw = (list(ctx.attr("group_size", [1, 1])) + [1, 1])[:2]
    ph = int(ctx.attr("pooled_height", 1))
    pw = int(ctx.attr("pooled_width", 1))
    part_h, part_w = (list(ctx.attr("part_size", [ph, pw]) or [ph, pw])
                      + [ph, pw])[:2]
    spp = int(ctx.attr("sample_per_part", 1))
    trans_std = float(ctx.attr("trans_std", 0.1))
    r = rois.shape[0]
    n, c, h, w = x.shape
    ids = _roi_images(ctx, r)
    x1 = torch.round(rois[:, 0]) * ss - 0.5
    y1 = torch.round(rois[:, 1]) * ss - 0.5
    x2 = (torch.round(rois[:, 2]) + 1.0) * ss - 0.5
    y2 = (torch.round(rois[:, 3]) + 1.0) * ss - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)[:, None, None]
    rh = torch.clamp(y2 - y1, min=0.1)[:, None, None]
    bin_w, bin_h = rw / pw, rh / ph
    sub_w, sub_h = bin_w / spp, bin_h / spp
    dev, dt = x.device, x.dtype
    pi = torch.arange(ph, device=dev).to(dt)[:, None]
    pj = torch.arange(pw, device=dev).to(dt)[None, :]

    def tables():
        i, j = np.arange(ph)[:, None], np.arange(pw)[None, :]
        ti = np.broadcast_to(i * part_h // ph, (ph, pw))
        tj = np.broadcast_to(j * part_w // pw, (ph, pw))
        gi = np.clip(i * gh // ph, 0, gh - 1)
        gj = np.clip(j * gw // pw, 0, gw - 1)
        return np.stack([ti, tj, np.broadcast_to(gi * gw + gj, (ph, pw))]
                        ).astype(np.int64)

    tab = ctx.host_table("deformable_psroi",
                         (ph, pw, part_h, part_w, gh, gw), tables)
    if ctx.attr("no_trans", False) or trans is None:
        dy = dx = torch.zeros((), dtype=dt, device=dev)
    else:
        dy = trans[:, 1][:, tab[0], tab[1]] * trans_std * rh
        dx = trans[:, 0][:, tab[0], tab[1]] * trans_std * rw
    rows = _channels_last(x)
    gsel = tab[2][None, :, :, None, None].expand(r, ph, pw, out_dim, 1)
    acc = None
    for si in range(spp):
        for sj in range(spp):
            yy = y1[:, None, None] + pi * bin_h + (si + 0.5) * sub_h + dy
            xx = x1[:, None, None] + pj * bin_w + (sj + 0.5) * sub_w + dx
            yy, xx = torch.broadcast_tensors(yy, xx)
            s = _bilinear(rows, h, w, ids, yy, xx).reshape(
                r, ph, pw, out_dim, gh * gw)
            s = torch.take_along_dim(s, gsel, dim=-1)[..., 0]
            acc = s if acc is None else acc + s
    out = (acc / (spp * spp)).permute(0, 3, 1, 2)
    ctx.set_output("Output", out)
    ctx.set_output("TopCount", torch.ones_like(out))


@register_op("tree_conv", no_grad_slots=("EdgeSet",))
def tree_conv(ctx):
    """Tree-based convolution (TBCNN) as the JAX op computes it: each
    node's patch is itself (top 1, left 0.5, right 0.5) and its direct
    children in EdgeSet order (top 0, left 1 - r, right r with r =
    i / (k - 1), 0.5 for an only child), whatever max_depth is; each
    member's features mix the three filter slices by its
    coefficients, and tanh is applied here (the builder's act applies
    another). The adjacency is built from EdgeSet on the host."""
    nodes = ctx.input("NodesVector")             # [N, n, F]
    filt = ctx.input("Filter")                   # [F, 3, out, filters]
    _eager_only(ctx)
    edges = tensor_to_numpy(ctx.input("EdgeSet"))  # [N, E, 2]
    bsz, n = nodes.shape[:2]
    eta = np.zeros((bsz, n, n, 3), np.float64)
    for b in range(bsz):
        children = {}
        for p, c in edges[b]:
            if int(p) == 0 and int(c) == 0:
                continue
            children.setdefault(int(p), []).append(int(c))
        for node in range(n):
            eta[b, node, node] += (1.0, 0.5, 0.5)
            ch = children.get(node, [])
            k = len(ch)
            for i, c in enumerate(ch):
                r = i / (k - 1) if k > 1 else 0.5
                eta[b, node, c] += (0.0, 1.0 - r, r)
    eta_t = _to(ctx, eta).to(nodes.dtype)
    ctx.set_output("Out", torch.tanh(torch.einsum(
        "bnik,bif,fkom->bnom", eta_t, nodes, filt)))


@register_op("lstmp", no_grad_slots=("C0",))
def lstmp(ctx):
    """LSTM with a recurrent projection over the sequences of Input's
    LoD: gates = x_t + r_{t-1} @ Weight + Bias[:4D] split (candidate, i,
    f, o), the peepholes in Bias[4D:7D] (i and f on c_{t-1}, o on c_t),
    r_t = proj_act((cell_act(c_t) * o) @ ProjWeight). The padded
    time-major loop of ops/rnn.py: each sequence's padding lies past its
    end."""
    from .rnn import _act, _from_time_major, _meta_states, _to_time_major
    from .sequence import _last_level
    x, w = ctx.input("Input"), ctx.input("Weight")   # [T, 4D], [P, 4D]
    wp, bias = ctx.input("ProjWeight"), ctx.input("Bias")  # [D, P]
    h0, c0 = ctx.input("H0"), ctx.input("C0")
    d, p = wp.shape
    if x.device.type == "meta":
        ctx.set_output("Projection",
                       _meta_states(x, p, x, w, wp, bias, h0, c0))
        ctx.set_output("Cell", _meta_states(x, d, x, w, wp, bias, h0, c0))
        ctx.set_lod("Projection", ctx.get_lod("Input"))
        ctx.set_lod("Cell", ctx.get_lod("Input"))
        return
    off = _last_level(ctx.get_lod("Input"))
    n = len(off) - 1
    act_g = _act(ctx.attr("gate_activation", "sigmoid"))
    act_c = _act(ctx.attr("cell_activation", "tanh"))
    act_n = _act(ctx.attr("candidate_activation", "tanh"))
    act_p = _act(ctx.attr("proj_activation", "tanh"))
    b = bias.reshape(-1) if bias is not None else x.new_zeros(4 * d)
    peep = bool(ctx.attr("use_peepholes", True)) and b.shape[0] >= 7 * d
    xs, _, unpack = _to_time_major(ctx, x, off,
                                   bool(ctx.attr("is_reverse", False)))
    r = h0 if h0 is not None else x.new_zeros((n, p))
    c = c0 if c0 is not None else x.new_zeros((n, d))
    rs, cs = [], []
    for xt in xs.unbind(0):
        g_in, g_i, g_f, g_o = (torch.addmm(xt, r, w) + b[:4 * d]).split(
            d, dim=1)
        if peep:
            g_i = g_i + b[4 * d:5 * d] * c
            g_f = g_f + b[5 * d:6 * d] * c
        c = act_n(g_in) * act_g(g_i) + c * act_g(g_f)
        if peep:
            g_o = g_o + b[6 * d:7 * d] * c
        r = act_p((act_c(c) * act_g(g_o)) @ wp)
        rs.append(r)
        cs.append(c)
    lod = ctx.get_lod("Input")
    ctx.set_output("Projection", _from_time_major(torch.stack(rs), unpack))
    ctx.set_output("Cell", _from_time_major(torch.stack(cs), unpack))
    ctx.set_lod("Projection", lod)
    ctx.set_lod("Cell", lod)


@register_no_grad_op("unique")
def unique(ctx):
    """The sorted distinct values of X (flattened) and each element's
    index among them (int32): a host read."""
    _eager_only(ctx)
    uniq, inv = np.unique(tensor_to_numpy(ctx.input("X")).reshape(-1),
                          return_inverse=True)
    ctx.set_output("Out", _to(ctx, uniq))
    ctx.set_output("Index", _to(ctx, inv.reshape(-1).astype(np.int32)))


@register_no_grad_op("unique_with_counts")
def unique_with_counts(ctx):
    """unique, with each distinct value's count (int32)."""
    _eager_only(ctx)
    uniq, inv, cnt = np.unique(
        tensor_to_numpy(ctx.input("X")).reshape(-1), return_inverse=True,
        return_counts=True)
    ctx.set_output("Out", _to(ctx, uniq))
    ctx.set_output("Index", _to(ctx, inv.reshape(-1).astype(np.int32)))
    ctx.set_output("Count", _to(ctx, cnt.astype(np.int32)))


def _writable(path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return open(path, "wb")


@register_no_grad_op("save")
def save_op(ctx):
    """X to file_path in the tensor file format of io.py (its LoD with
    it): a host copy, so the block runs eagerly."""
    from ..io import _serialize_tensor
    _eager_only(ctx)
    name = ctx.op.input("X")[0]
    with _writable(ctx.attr("file_path")) as f:
        _serialize_tensor(f, name, tensor_to_numpy(ctx.input("X")),
                          ctx.get_lod("X"))


@register_no_grad_op("load")
def load_op(ctx):
    """Out from the first tensor of file_path (float16 with
    load_as_fp16), with its LoD."""
    from ..io import _deserialize_tensors
    _eager_only(ctx)
    with open(ctx.attr("file_path"), "rb") as f:
        arr, lod = next(iter(_deserialize_tensors(f).values()))
    val = _to(ctx, arr)
    if ctx.attr("load_as_fp16", False):
        val = val.to(torch.float16)
    ctx.env[ctx.op.output("Out")[0]] = val
    if lod:
        ctx.set_lod("Out", lod)


@register_no_grad_op("save_combine")
def save_combine(ctx):
    """Every X, in order, into the one file file_path."""
    from ..io import _serialize_tensor
    _eager_only(ctx)
    with _writable(ctx.attr("file_path")) as f:
        for n, v in zip(ctx.op.input("X"), ctx.inputs("X")):
            _serialize_tensor(f, n, tensor_to_numpy(v),
                              ctx.lod_env.get(n, []))


@register_no_grad_op("load_combine")
def load_combine(ctx):
    """Each Out from the tensor of its name in file_path."""
    from ..io import _deserialize_tensors
    _eager_only(ctx)
    with open(ctx.attr("file_path"), "rb") as f:
        tensors = _deserialize_tensors(f)
    for n in ctx.op.output("Out"):
        arr, lod = tensors[n]
        ctx.env[n] = _to(ctx, arr)
        if lod:
            ctx.lod_env[n] = [list(lv) for lv in lod]


@register_op("dense_lstm", no_grad_slots=("InitH", "InitC"))
def dense_lstm(ctx):
    """A batched multi-layer (bi)LSTM over Input [B, T, D] (the
    reference's cudnn_lstm contract): the flat W holds, for each layer
    and direction, [Wx (din x 4H), Wh (H x 4H), bx (4H), bh (4H)]; the
    gates split (i, f, o, candidate); InitH / InitC and LastH / LastC
    are [layers * dirs, B, H]. Between layers, dropout_prob drops from
    the op's generator (not under is_test). One GEMM a layer and
    direction takes the input projections of every step, then a torch
    loop over T adds h @ Wh, so a captured block is one CUDA graph."""
    x, w = ctx.input("Input"), ctx.input("W")
    h0, c0 = ctx.input("InitH"), ctx.input("InitC")
    hid = int(ctx.attr("hidden_size"))
    layers = int(ctx.attr("num_layers", 1))
    dirs = 2 if ctx.attr("is_bidirec", False) else 1
    bsz, t, _ = x.shape
    if x.device.type == "meta":
        reach = sum(v.sum() for v in (x, w, h0, c0) if v is not None) * 0
        ctx.set_output("Out", x.new_zeros((bsz, t, hid * dirs)) + reach)
        for slot in ("LastH", "LastC"):
            ctx.set_output(slot, x.new_zeros((layers * dirs, bsz, hid))
                           + reach)
        return
    drop = float(ctx.attr("dropout_prob", 0.0))
    gen = ctx.generator() if drop > 0.0 and layers > 1 and \
        not ctx.attr("is_test", False) else None
    pos = 0

    def take(k):
        nonlocal pos
        pos += k
        return w[pos - k:pos]

    out = x
    last_h, last_c = [], []
    for layer in range(layers):
        if layer > 0 and gen is not None:
            keep = 1.0 - drop
            m = torch.rand(out.shape, generator=gen, device=out.device,
                           dtype=out.dtype) < keep
            out = torch.where(m, out / keep, torch.zeros_like(out))
        din = out.shape[-1]
        seq = out.transpose(0, 1)                # [T, B, din]
        outs = []
        for dr in range(dirs):
            wx = take(din * 4 * hid).view(din, 4 * hid)
            wh = take(hid * 4 * hid).view(hid, 4 * hid)
            b = take(4 * hid) + take(4 * hid)
            k = layer * dirs + dr
            h = h0[k] if h0 is not None else x.new_zeros((bsz, hid))
            c = c0[k] if c0 is not None else x.new_zeros((bsz, hid))
            s = seq.flip(0) if dr == 1 else seq
            xw = torch.addmm(b, s.reshape(t * bsz, din), wx).view(
                t, bsz, 4 * hid)
            hs = []
            for xt in xw.unbind(0):
                gates = torch.addmm(xt, h, wh).view(bsz, 4, hid)
                sg = torch.sigmoid(gates[:, :3])
                i, f, o = sg.unbind(1)
                c = f * c + i * torch.tanh(gates[:, 3])
                h = o * torch.tanh(c)
                hs.append(h)
            hs = torch.stack(hs)                 # [T, B, H]
            outs.append(hs.flip(0) if dr == 1 else hs)
            last_h.append(h)
            last_c.append(c)
        out = (torch.cat(outs, dim=-1) if dirs > 1 else outs[0]
               ).transpose(0, 1)
    ctx.set_output("Out", out)
    ctx.set_output("LastH", torch.stack(last_h))
    ctx.set_output("LastC", torch.stack(last_c))


# cudnn_lstm: the same lowering (the JAX package's alias), with its own
# generic gradient
register_op("cudnn_lstm", no_grad_slots=("InitH", "InitC"))(dense_lstm)

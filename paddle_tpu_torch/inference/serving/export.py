"""The serving export: a Program pair frozen into bucketed prefill and
decode signatures (counterpart of paddle_tpu/inference/serving/
export.py).

The export contract
-------------------
A serving model is two frozen Programs over one set of parameter values
(the same ``ParamAttr`` names, one startup run, two
``save_inference_model`` directories and a ``serving.json``
manifest):

* **prefill** — feeds ``tokens [B,S]`` int64, ``pos [B,S]`` int64 and
  the additive float32 ``mask [B,S,S]``; fetches ``logits [B,S,V]`` and
  each layer's ``k_i`` / ``v_i [B,S,H]`` (the prompt's rows, which the
  engine writes into cache pages);
* **decode** — feeds ``token [B,1]``, ``pos [B,1]``, each layer's dense
  ``cache_k_i`` / ``cache_v_i [B,S,H]`` (gathered from the pages) and
  ``mask [B,1,S+1]``; fetches ``logits [B,1,V]`` and the new token's
  ``k_i`` / ``v_i [B,1,H]``.

Masks and positions are made on the host and fed. Every dispatch has
the fixed batch ``B`` and a length from the declared buckets
(``BucketSpec``), and ``FrozenServingModel.warmup`` captures each of
those signatures as one CUDA graph (inference.AnalysisPredictor), so a
request that joins a running batch never meets an uncaptured shape.
The directories are the JAX package's format: either package loads what
the other exported.

Bit-identity: every op of the two programs is row-independent, and a
padded row or masked position gets exactly zero attention weight (the
additive -1e30 absorbs any finite stale score, then exp underflows to
0.0), so a request's tokens are the same alone or in a batch, wherever
each output row depends on its own row only: float32 torch.matmul, the
tuned GEMM, the bf16 GEMM. The int8 GEMM's scales are one per 128x128
tile of x, so there a request's logits depend on its batch mates, as in
the JAX kernel. AMP stays off: a bf16 mask or score would break the
argument.

Sharding (``PT_SERVE_MESH``) waits for multi-card work (ROADMAP.md A.7):
on one device a spec is ignored with a warning, as in the reference; on
more it raises.
"""
from __future__ import annotations

import json
import math
import os
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ... import framework, io, layers
from ...core.place import CPUPlace, default_place
from ...param_attr import ParamAttr
from .. import _RUN_LOCK, AnalysisConfig, create_paddle_predictor

__all__ = ["BucketSpec", "bucket_for", "build_book_lm",
           "export_serving_model", "load_serving_model",
           "FrozenServingModel", "resolve_serving_mesh",
           "reference_generate", "prefill_feeds", "decode_feeds",
           "NEG_MASK"]

# the additive mask of a forbidden position: any finite stale score is
# absorbed exactly (score + -1e30 == -1e30 in float32) and its exp
# underflows to exactly 0.0
NEG_MASK = -1e30

MANIFEST = "serving.json"


class BucketSpec:
    """The declared dispatch signatures: one batch size, sorted prefill
    lengths and decode cache lengths."""

    def __init__(self, batch: int = 4,
                 prefill_lens: Sequence[int] = (16,),
                 cache_lens: Sequence[int] = (48,)):
        self.batch = int(batch)
        self.prefill_lens = tuple(sorted(int(x) for x in prefill_lens))
        self.cache_lens = tuple(sorted(int(x) for x in cache_lens))
        if not self.prefill_lens or not self.cache_lens:
            raise ValueError("need at least one bucket per phase")

    @property
    def max_context(self) -> int:
        """The longest sequence: the cache holds at most max(cache_lens)
        tokens before the step that appends the next."""
        return self.cache_lens[-1]

    def to_dict(self) -> dict:
        return {"batch": self.batch,
                "prefill_lens": list(self.prefill_lens),
                "cache_lens": list(self.cache_lens)}

    @classmethod
    def from_dict(cls, d) -> "BucketSpec":
        return cls(d["batch"], d["prefill_lens"], d["cache_lens"])


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= n; raises past the largest."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds declared buckets {buckets}")


# ---------------------------------------------------------------------------
# the book model: a single-head decoder LM
# ---------------------------------------------------------------------------

def _attn_layer(h, mask, i, hidden, cache_k=None, cache_v=None):
    """One attention + FFN block with residuals; (h, k, v), k and v this
    segment's rows (the prompt's in prefill, the new token's in
    decode)."""
    def pa(n):
        return ParamAttr(name=f"lm.l{i}.{n}.w")

    def ba(n):
        return ParamAttr(name=f"lm.l{i}.{n}.b")

    q = layers.fc(h, hidden, num_flatten_dims=2,
                  param_attr=pa("q"), bias_attr=ba("q"))
    k = layers.fc(h, hidden, num_flatten_dims=2,
                  param_attr=pa("k"), bias_attr=ba("k"))
    v = layers.fc(h, hidden, num_flatten_dims=2,
                  param_attr=pa("v"), bias_attr=ba("v"))
    if cache_k is not None:
        full_k = layers.concat([cache_k, k], axis=1)
        full_v = layers.concat([cache_v, v], axis=1)
    else:
        full_k, full_v = k, v
    scores = layers.matmul(q, full_k, transpose_y=True,
                           alpha=1.0 / math.sqrt(hidden))
    scores = layers.elementwise_add(scores, mask)
    probs = layers.softmax(scores, axis=-1)
    att = layers.matmul(probs, full_v)
    o = layers.fc(att, hidden, num_flatten_dims=2,
                  param_attr=pa("o"), bias_attr=ba("o"))
    h = layers.elementwise_add(h, o)
    f = layers.fc(h, hidden * 2, num_flatten_dims=2, act="relu",
                  param_attr=pa("f1"), bias_attr=ba("f1"))
    f = layers.fc(f, hidden, num_flatten_dims=2,
                  param_attr=pa("f2"), bias_attr=ba("f2"))
    h = layers.elementwise_add(h, f)
    return h, k, v


def build_book_lm(vocab: int = 50, hidden: int = 16,
                  num_layers: int = 2, max_len: int = 128):
    """(prefill_prog, decode_prog, startup_prog, meta) of the serving
    book model. Both programs name the same parameters, so one startup
    run initializes the weights both serve."""
    meta = {"vocab": vocab, "hidden": hidden,
            "num_layers": num_layers, "max_len": max_len}

    def embed(toks, pos):
        emb = layers.embedding(toks, size=[vocab, hidden],
                               param_attr=ParamAttr(name="lm.tok_emb"))
        pemb = layers.embedding(pos, size=[max_len, hidden],
                                param_attr=ParamAttr(name="lm.pos_emb"))
        return layers.elementwise_add(emb, pemb)

    def head(h):
        return layers.fc(h, vocab, num_flatten_dims=2,
                         param_attr=ParamAttr(name="lm.head.w"),
                         bias_attr=ParamAttr(name="lm.head.b"))

    prefill, startup = framework.Program(), framework.Program()
    with framework.program_guard(prefill, startup):
        toks = layers.data("tokens", [-1], dtype="int64")
        pos = layers.data("pos", [-1], dtype="int64")
        mask = layers.data("mask", [-1, -1], dtype="float32")
        h = embed(toks, pos)
        kvs = []
        for i in range(num_layers):
            h, k, v = _attn_layer(h, mask, i, hidden)
            kvs.extend([k, v])
        logits = head(h)
    meta["prefill_fetches"] = [logits.name] + [t.name for t in kvs]

    decode, dec_startup = framework.Program(), framework.Program()
    with framework.program_guard(decode, dec_startup):
        # shape [1]: lookup_table squeezes a trailing id dim of 1, and
        # shape inference must see the squeeze the [B,1] feed takes
        toks = layers.data("token", [1], dtype="int64")
        pos = layers.data("pos", [1], dtype="int64")
        mask = layers.data("mask", [-1, -1], dtype="float32")
        caches = [(layers.data(f"cache_k_{i}", [-1, hidden],
                               dtype="float32"),
                   layers.data(f"cache_v_{i}", [-1, hidden],
                               dtype="float32"))
                  for i in range(num_layers)]
        # [B,1] ids embed to [B,H]: restore the length-1 sequence axis
        h = layers.unsqueeze(embed(toks, pos), [1])
        kvs = []
        for i, (ck, cv) in enumerate(caches):
            h, k, v = _attn_layer(h, mask, i, hidden, cache_k=ck,
                                  cache_v=cv)
            kvs.extend([k, v])
        logits = head(h)
    meta["decode_fetches"] = [logits.name] + [t.name for t in kvs]
    # decode names the same parameters; its startup is never run
    return prefill, decode, startup, meta


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def export_serving_model(dirname: str, exe, prefill_prog, decode_prog,
                         meta: dict,
                         buckets: Optional[BucketSpec] = None) -> dict:
    """Write an initialized model (the global scope holds the weights)
    as ``<dirname>/prefill`` and ``<dirname>/decode`` inference
    directories and a ``serving.json`` manifest; returns the
    manifest."""
    num_layers = int(meta["num_layers"])
    pre_feeds = ["tokens", "pos", "mask"]
    dec_feeds = ["token", "pos", "mask"] + \
        [f"cache_{kv}_{i}" for i in range(num_layers) for kv in ("k", "v")]
    io.save_inference_model(
        os.path.join(dirname, "prefill"), pre_feeds,
        list(meta["prefill_fetches"]), exe, main_program=prefill_prog)
    io.save_inference_model(
        os.path.join(dirname, "decode"), dec_feeds,
        list(meta["decode_fetches"]), exe, main_program=decode_prog)
    manifest = dict(meta)
    manifest["prefill_feeds"] = pre_feeds
    manifest["decode_feeds"] = dec_feeds
    manifest["buckets"] = (buckets or BucketSpec()).to_dict()
    with open(os.path.join(dirname, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def resolve_serving_mesh(spec: Optional[str] = None):
    """Parse a ``"data=2,tp=4"`` spec (the argument, else
    ``PT_SERVE_MESH``). None without a spec, and, with a warning, when
    one card at most is visible: one-card serving is unsharded. With
    more cards a spec raises: sharded serving waits for multi-card work
    (ROADMAP.md A.7)."""
    if spec is None:
        spec = os.environ.get("PT_SERVE_MESH", "")
    spec = (spec or "").strip()
    if not spec:
        return None
    axes = {}
    for item in spec.split(","):
        k, _, v = item.strip().partition("=")
        if k not in ("data", "fsdp", "tp"):
            raise ValueError(
                f"unknown serving mesh axis {k!r} in {spec!r}; known: "
                f"data, fsdp, tp")
        axes[k] = int(v)
    n = torch.cuda.device_count()
    if n < 2:
        warnings.warn(
            f"PT_SERVE_MESH={spec!r} requested but only {n} device is "
            f"attached; serving unsharded", stacklevel=2)
        return None
    raise NotImplementedError(
        f"PT_SERVE_MESH={spec!r} on {n} cards: sharded serving is not "
        f"ported yet (ROADMAP.md A.7); unset it to serve from one card")


class FrozenServingModel:
    """A loaded serving export: two AnalysisPredictors (prefill, decode)
    and the manifest, on `place` (None: the card, CUDAPlace(0); pass
    CPUPlace() for the CPU). The raw interface the scheduler calls:
    numpy and tensors in, logits as numpy and k/v as tensors on the
    model's device out."""

    def __init__(self, dirname: str, buckets: Optional[BucketSpec] = None,
                 mesh_spec: Optional[str] = None, place=None):
        with open(os.path.join(dirname, MANIFEST)) as f:
            self.meta = json.load(f)
        self.buckets = buckets or BucketSpec.from_dict(
            self.meta["buckets"])
        self.num_layers = int(self.meta["num_layers"])
        self.hidden = int(self.meta["hidden"])
        self.vocab = int(self.meta["vocab"])
        self.mesh_spec = resolve_serving_mesh(mesh_spec)
        self.place = default_place() if place is None else place
        self.device = self.place.torch_device()

        def _cfg(sub):
            cfg = AnalysisConfig(os.path.join(dirname, sub))
            if isinstance(self.place, CPUPlace):
                cfg.disable_gpu()
            return cfg

        self._pp = create_paddle_predictor(_cfg("prefill"))
        self._dp = create_paddle_predictor(_cfg("decode"))

    # -- raw entry points ----------------------------------------------------

    @staticmethod
    def _prefill_inputs(tokens, pos, mask):
        return {"tokens": np.asarray(tokens, np.int64),
                "pos": np.asarray(pos, np.int64),
                "mask": np.asarray(mask, np.float32)}

    def _kv(self, outs, row=slice(None)):
        L = self.num_layers
        return (torch.stack([outs[1 + 2 * i][row] for i in range(L)]),
                torch.stack([outs[2 + 2 * i][row] for i in range(L)]))

    def prefill(self, tokens, pos, mask):
        """``tokens`` / ``pos`` int64 ``[B,S]``, ``mask`` float32
        ``[B,S,S]`` -> (logits ``[B,S,V]`` numpy, k ``[L,B,S,H]``
        tensor, v the same)."""
        outs = self._pp._run_feeds(self._prefill_inputs(tokens, pos, mask),
                                   to_host={0})
        return (outs[0],) + self._kv(outs)

    def prefill_rows(self, tokens, pos, mask, rows):
        """prefill, with the logits of row b's position rows[b] alone:
        ``[B,V]`` numpy, picked on the device before the host copy (the
        scheduler reads each prompt's last position only; the values are
        prefill's, bit for bit)."""
        with _RUN_LOCK:
            outs = self._pp._run_feeds(
                self._prefill_inputs(tokens, pos, mask))
            lg = outs[0]
            idx = torch.as_tensor(np.asarray(rows, np.int64),
                                  device=lg.device)
            picked = lg[torch.arange(lg.shape[0], device=lg.device), idx]
            logits = picked.cpu().numpy()
        return (logits,) + self._kv(outs)

    def decode(self, token, pos, mask, cache_k, cache_v):
        """``token`` / ``pos`` int64 ``[B,1]``, ``mask`` float32
        ``[B,1,S+1]``, ``cache_k`` / ``cache_v`` ``[L,B,S,H]`` (tensors on
        the model's device, or numpy) -> (logits ``[B,V]`` numpy, k_new
        ``[L,B,H]`` tensor, v_new the same)."""
        feeds = {"token": np.asarray(token, np.int64),
                 "pos": np.asarray(pos, np.int64),
                 "mask": np.asarray(mask, np.float32)}
        for i in range(self.num_layers):
            feeds[f"cache_k_{i}"] = cache_k[i]
            feeds[f"cache_v_{i}"] = cache_v[i]
        outs = self._dp._run_feeds(feeds, to_host={0})
        return (outs[0][:, 0, :],) + self._kv(outs, (slice(None), 0))

    # -- capture ahead -------------------------------------------------------

    def warmup(self) -> int:
        """Capture every declared (batch, bucket) signature, so that no
        dispatch after it plans or captures: each signature runs twice
        (the engine's first run plans it, its second captures it), with
        the feed types the scheduler gives (host arrays; the decode
        caches as tensors on the model's device). Returns the number of
        signatures."""
        B, L, H = self.buckets.batch, self.num_layers, self.hidden
        n = 0
        for S in self.buckets.prefill_lens:
            feeds = self._prefill_inputs(
                np.zeros((B, S), np.int64), np.zeros((B, S), np.int64),
                np.full((B, S, S), NEG_MASK, np.float32))
            for _ in range(2):
                self._pp._run_feeds(feeds)
            n += 1
        for S in self.buckets.cache_lens:
            zero = torch.zeros((B, S, H), dtype=torch.float32,
                               device=self.device)
            feeds = {"token": np.zeros((B, 1), np.int64),
                     "pos": np.zeros((B, 1), np.int64),
                     "mask": np.full((B, 1, S + 1), NEG_MASK, np.float32)}
            for i in range(L):
                feeds[f"cache_k_{i}"] = feeds[f"cache_v_{i}"] = zero
            for _ in range(2):
                self._dp._run_feeds(feeds)
            n += 1
        return n

    def engine_counters(self) -> dict:
        """The two predictors' engine counters, summed (captures,
        replays, eager_runs, ...)."""
        a, b = self._pp._engine.counters, self._dp._engine.counters
        return {k: a[k] + b[k] for k in a}


def load_serving_model(dirname: str,
                       buckets: Optional[BucketSpec] = None,
                       mesh_spec: Optional[str] = None,
                       place=None) -> FrozenServingModel:
    return FrozenServingModel(dirname, buckets=buckets,
                              mesh_spec=mesh_spec, place=place)


# ---------------------------------------------------------------------------
# host-side feed builders (the engine's and the solo baseline's)
# ---------------------------------------------------------------------------

def prefill_feeds(prompts: List[List[int]], S: int, B: int):
    """Padded prefill feeds for up to B prompts: a causal mask over each
    prompt's tokens, NEG_MASK everywhere else (a dead row softmaxes
    uniformly: finite, unused)."""
    tokens = np.zeros((B, S), np.int64)
    pos = np.zeros((B, S), np.int64)
    mask = np.full((B, S, S), NEG_MASK, np.float32)
    for b, p in enumerate(prompts[:B]):
        n = len(p)
        tokens[b, :n] = p
        pos[b, :n] = np.arange(n)
        tri = np.triu(np.ones((n, n), bool), k=1)
        mask[b, :n, :n] = np.where(tri, NEG_MASK, 0.0)
    return tokens, pos, mask


def decode_feeds(last_tokens: List[Optional[int]],
                 lens: List[int], S: int, B: int):
    """One decode step's feeds: row b attends its ``lens[b]`` cache
    positions and itself (slot S); everything else is NEG_MASK."""
    token = np.zeros((B, 1), np.int64)
    pos = np.zeros((B, 1), np.int64)
    mask = np.full((B, 1, S + 1), NEG_MASK, np.float32)
    for b, t in enumerate(last_tokens[:B]):
        if t is None:
            continue
        token[b, 0] = t
        pos[b, 0] = lens[b]
        mask[b, 0, :lens[b]] = 0.0
        mask[b, 0, S] = 0.0          # the new token attends itself
    return token, pos, mask


def reference_generate(model: FrozenServingModel, prompt: List[int],
                       max_new_tokens: int) -> List[int]:
    """The parity baseline: one request alone through the predictors
    with a dense cache, row 0 of a padded batch, the same buckets and
    signatures. The continuous-batching engine's tokens must equal
    these. The dense cache lives on the model's device (the reference
    keeps it on the host: a B=128 cache would cross the bus every
    step)."""
    bk = model.buckets
    B = bk.batch
    Sp = bucket_for(len(prompt), bk.prefill_lens)
    tokens, pos, mask = prefill_feeds([list(prompt)], Sp, B)
    logits, k, v = model.prefill(tokens, pos, mask)
    n = len(prompt)
    out = [int(np.argmax(logits[0, n - 1]))]
    # dense cache of every row, [L, B, n, H], grown bucket by bucket
    k, v = k[:, :, :n, :], v[:, :, :n, :]
    while len(out) < max_new_tokens:
        S = bucket_for(n, bk.cache_lens)
        L, _, _, H = k.shape
        ck = k.new_zeros((L, B, S, H))
        cv = v.new_zeros((L, B, S, H))
        ck[:, :, :n, :] = k
        cv[:, :, :n, :] = v
        token, dpos, dmask = decode_feeds(
            [out[-1]] + [None] * (B - 1), [n] * B, S, B)
        logits, k_new, v_new = model.decode(token, dpos, dmask, ck, cv)
        out.append(int(np.argmax(logits[0])))
        k = torch.cat([k, k_new[:, :, None, :]], dim=2)
        v = torch.cat([v, v_new[:, :, None, :]], dim=2)
        n += 1
    return out

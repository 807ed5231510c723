"""The inference predictor (counterpart of paddle_tpu/inference/).

Fluid's API: ``create_paddle_predictor(AnalysisConfig(model_dir))``
gives an ``AnalysisPredictor`` that loads a saved inference model (the
port's io.load_inference_model reads the JAX package's ``__model__``
and params files as well as its own) and serves ``run()`` with
PaddleTensors and the ZeroCopy calls (get_input_tensor /
copy_from_cpu / zero_copy_run / copy_to_cpu).

The JAX predictor traces the program once per input signature into one
XLA executable. Here an entry per signature runs the program through
the port's Engine with the plan cache on: a signature's first run is
eager and builds its plan, its second captures the block as one CUDA
graph (core/engine.py _Captured), and every later run replays it, so
the per-signature "compile" of the reference is a capture. The engine
keeps every signature's plan (no bound a key).

A feed may be a numpy array (copied to the card through pinned memory
on a replay) or a torch tensor already on the predictor's device (copied
on the device into the graph's static input: no host round trip).
``_run_feeds`` returns the fetches as tensors on the device unless the
caller asks for host copies.

Threads: the capture of a CUDA graph switches torch's sync debug mode
for the whole process and refuses other work on the card while it
runs, so every run of every predictor (the capture, the replay and the
fetches' host copies) holds one process-wide lock. Capture every
signature (FrozenServingModel.warmup) before serving threads start;
one first met later captures under the same lock.

AOT: the JAX predictor serializes its executable (StableHLO) next to
the model so a new process skips the trace. A CUDA graph has no on-disk
form: ``enable_aot`` is accepted and writes nothing, and a new process
plans and captures again (ROADMAP.md A.10).

LoD feeds (ZeroCopyTensor.set_lod, PaddleTensor.lod) go to the engine
as LoDTensors; each LoD is its own signature, with its own plan and
capture, and a fetch's LoD comes back (ZeroCopyTensor.lod() of an
output, PaddleTensor.lod). A LoD that does not partition its feed's
rows is refused.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import io as _io
from ..core.engine import Engine
from ..core.place import CPUPlace, default_place
from ..core.scope import LoDTensor, Scope, scope_guard, tensor_to_numpy
from ..core.types import dtype_to_np
from ..executor import Executor
from ..observability import memory as _obs_memory

__all__ = ["AnalysisConfig", "AnalysisPredictor", "PaddleTensor",
           "ZeroCopyTensor", "create_paddle_predictor"]

# every predictor run, capture and host copy (see the module docstring)
_RUN_LOCK = threading.RLock()


class AnalysisConfig:
    """Reference paddle_analysis_config.h: the model's location and the
    device; the analysis and memory switches are accepted and change
    nothing (the engine plans every run)."""

    def __init__(self, model_dir: str = None, prog_file: str = None,
                 params_file: str = None):
        self._model_dir = model_dir
        self._prog_file = prog_file
        self._params_file = params_file
        self._use_accelerator = True
        self._enable_aot = True
        self._ir_optim = True

    def set_model(self, model_dir, params_file=None):
        self._model_dir = model_dir
        self._params_file = params_file
        return self

    def model_dir(self):
        return self._model_dir

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Serve on the card (the default)."""
        self._use_accelerator = True

    def disable_gpu(self):
        """Serve on the CPU."""
        self._use_accelerator = False

    def use_gpu(self):
        return self._use_accelerator

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def enable_memory_optim(self):
        pass

    def switch_use_feed_fetch_ops(self, flag):
        pass

    def switch_specify_input_names(self, flag=True):
        pass

    def set_cpu_math_library_num_threads(self, n):
        pass

    def enable_aot(self, flag=True):
        """Accepted for the reference's API. A CUDA graph cannot be
        written to disk, so no artifact is written or read: a new
        process plans and captures each signature again."""
        self._enable_aot = flag


class PaddleTensor:
    """Run()'s payload (reference paddle_api.h PaddleTensor)."""

    def __init__(self, data=None, name=""):
        self.name = name
        self.data = np.asarray(data) if data is not None else None
        self.lod = []

    @property
    def shape(self):
        return list(self.data.shape)


class ZeroCopyTensor:
    """Reference ZeroCopyTensor: reads and writes the predictor's own
    buffers."""

    def __init__(self, name: str, predictor: "AnalysisPredictor",
                 is_input: bool):
        self._name = name
        self._pred = predictor
        self._is_input = is_input

    def name(self):
        return self._name

    def copy_from_cpu(self, arr):
        """A numpy array, or a torch tensor (one on the predictor's
        device is fed without a host round trip)."""
        assert self._is_input, "output tensors are read-only"
        self._pred._inputs[self._name] = arr if isinstance(
            arr, torch.Tensor) else np.ascontiguousarray(arr)

    def set_lod(self, lod):
        assert self._is_input, "output tensors are read-only"
        self._pred._input_lods[self._name] = [list(lv) for lv in lod]

    def lod(self):
        if self._is_input:
            return self._pred._input_lods.get(self._name, [])
        return self._pred._output_lods.get(self._name, [])

    def copy_to_cpu(self):
        return self._pred._outputs[self._name]

    def shape(self):
        if self._is_input:
            return list(self._pred._inputs[self._name].shape)
        return list(self.copy_to_cpu().shape)


class AnalysisPredictor:
    """Load once, plan and capture per input signature (reference
    analysis_predictor.h:46)."""

    def __init__(self, config: AnalysisConfig):
        self._config = config
        self._scope = Scope()
        self._place = default_place() if config.use_gpu() else CPUPlace()
        exe = Executor(self._place)
        with scope_guard(self._scope):
            (self._program, self._feed_names,
             fetch_vars) = _io.load_inference_model(
                config.model_dir(), exe,
                model_filename=config._prog_file,
                params_filename=config._params_file)
        self._fetch_names = [v.name for v in fetch_vars]
        self._init_buffers()

    def _init_buffers(self):
        block = self._program.global_block()
        self._feed_dtypes = {n: dtype_to_np(block.find_var(n).dtype)
                             for n in self._feed_names
                             if block.find_var(n) is not None}
        self._inputs: Dict[str, object] = {}
        self._input_lods: Dict[str, list] = {}
        self._outputs: Dict[str, np.ndarray] = {}
        self._output_lods: Dict[str, list] = {}
        self._last_lods: List[list] = []
        # signature -> runs; the engine keeps every signature's plan
        self._compiled: Dict[tuple, int] = {}
        self._engine = Engine(max_plans=None)
        _obs_memory.track_predictor(self)

    # -- ZeroCopy contract ---------------------------------------------------

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def get_input_tensor(self, name) -> ZeroCopyTensor:
        assert name in self._feed_names, name
        return ZeroCopyTensor(name, self, is_input=True)

    def get_output_tensor(self, name) -> ZeroCopyTensor:
        assert name in self._fetch_names, name
        return ZeroCopyTensor(name, self, is_input=False)

    def zero_copy_run(self):
        outs = self._run_feeds(dict(self._inputs), dict(self._input_lods),
                               to_host=True)
        self._outputs = dict(zip(self._fetch_names, outs))
        self._output_lods = dict(zip(self._fetch_names, self._last_lods))

    # -- classic Run ---------------------------------------------------------

    def run(self, inputs: Sequence[PaddleTensor]) -> List[PaddleTensor]:
        feeds, lods = {}, {}
        for i, t in enumerate(inputs):
            name = t.name or self._feed_names[i]
            feeds[name] = np.asarray(t.data)
            if t.lod:
                lods[name] = [list(lv) for lv in t.lod]
        outs = self._run_feeds(feeds, lods, to_host=True)
        result = []
        for n, o, lod in zip(self._fetch_names, outs, self._last_lods):
            result.append(PaddleTensor(o, n))
            result[-1].lod = lod
        return result

    def clone(self) -> "AnalysisPredictor":
        """A predictor over this one's loaded weights (the same scope: no
        second read of the model directory) with its own buffers and its
        own plans and captures (reference analysis_predictor.h Clone)."""
        twin = AnalysisPredictor.__new__(AnalysisPredictor)
        twin._config = self._config
        twin._scope = self._scope
        twin._place = self._place
        twin._program = self._program
        twin._feed_names = list(self._feed_names)
        twin._fetch_names = list(self._fetch_names)
        twin._init_buffers()
        return twin

    # -- signatures ----------------------------------------------------------

    def _canonical(self, feeds):
        """Each feed as a torch tensor: numpy arrays in the dtype the
        program declares, without a copy (torch.from_numpy); tensors as
        they are (the engine casts them on their device)."""
        out = {}
        for n, a in feeds.items():
            if not isinstance(a, torch.Tensor):
                a = np.asarray(a)
                want = self._feed_dtypes.get(n)
                if want is not None and a.dtype != want:
                    a = a.astype(want)
                a = torch.from_numpy(np.ascontiguousarray(a))
            out[n] = a
        return out

    @staticmethod
    def _sig_of(feeds, lods=None):
        """(name, shape, dtype, LoD) of each feed: each LoD is its own
        signature, with its own plan and capture."""
        lods = lods or {}
        return tuple((n, tuple(feeds[n].shape), str(feeds[n].dtype),
                      tuple(map(tuple, lods.get(n, ()))))
                     for n in sorted(feeds))

    def _run_feeds(self, feeds, lods=None, to_host=False):
        """The fetches of one run on `feeds` with the offsets of `lods`
        (name -> LoD): tensors on the device, or numpy copies (`to_host`:
        True for all, or a set of indices), made under the run lock. The
        fetches' LoDs are left in `_last_lods`."""
        feeds = self._canonical(feeds)
        lods = {n: lod for n, lod in (lods or {}).items() if lod}
        sig = self._sig_of(feeds, lods)
        fed = dict(feeds)
        for n, lod in lods.items():
            t = LoDTensor(feeds[n], lod)
            if not t.has_valid_recursive_sequence_lengths():
                raise ValueError(
                    f"feed {n!r}: LoD {lod} does not partition its "
                    f"{feeds[n].shape[0] if feeds[n].dim() else 0} rows")
            fed[n] = t
        with _RUN_LOCK:
            self._compiled[sig] = self._compiled.get(sig, 0) + 1
            outs = self._engine.run(self._program, self._scope,
                                    self._place, fed, self._fetch_names,
                                    return_numpy=False)
            self._last_lods = [o.lod() if isinstance(o, LoDTensor) else []
                               for o in outs]
            outs = [o.tensor if isinstance(o, LoDTensor) else o
                    for o in outs]
            if to_host:
                outs = [tensor_to_numpy(o)
                        if to_host is True or i in to_host else o
                        for i, o in enumerate(outs)]
        return outs

    def _census_arrays(self):
        """(label, tensor) of the device memory this predictor holds: its
        scope's persistables and its captured signatures' static
        tensors (observability/memory.py)."""
        for n in self._scope.local_var_names():
            v = self._scope.find_var(n)
            t = v.get_tensor().tensor if v.is_initialized() else None
            if isinstance(t, torch.Tensor):
                yield f"scope:{n}", t
        yield from self._engine.captured_tensors()


def create_paddle_predictor(config: AnalysisConfig) -> AnalysisPredictor:
    """Reference CreatePaddlePredictor<AnalysisConfig>
    (paddle_api.h:338)."""
    return AnalysisPredictor(config)

"""The contrib seq2seq decoder API (counterpart of
paddle_tpu/contrib/decoder.py): InitState, StateCell, TrainingDecoder and
BeamSearchDecoder.

As in the JAX package both decoders unroll statically: the
TrainingDecoder over the dense padded time axis of its step input, the
BeamSearchDecoder over `max_len` steps, while keeping the reference's
programming model (a StateCell holds named states, a registered
@state_updater computes one step, step inputs come from get_input). The
beam decoder's selection is the frozen-beam layers.beam_search (a source
keeps beam_size rows; a finished beam re-emits (end_id, its score)), its
reorder a gather by the parent rows, and its result beam_search_decode
over the stacked steps, so a decode is shape-static for a source LoD and
the engine captures it as one CUDA graph.

Every parameter inside a step body is built once a step, so it must have
a fixed name: the beam decoder names its own '<name>_emb.w_0' and
'<name>_fc.{w,b}_0', and an updater passes explicit ParamAttr names.
"""
from __future__ import annotations

import contextlib

from .. import layers
from ..param_attr import ParamAttr

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]


class InitState:
    """A state's initial value: `init` itself, or a `value`-filled
    `shape` whose batch dim is init_boot's."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is not None:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, shape=shape, dtype=dtype, value=value)
        else:
            raise ValueError("InitState needs `init` or `init_boot` to "
                             "size the batch dim")
        self._need_reorder = need_reorder

    @property
    def value(self):
        return self._init


class StateCell:
    """Named decoding states and the registered updater that computes
    one step of them from the step's inputs."""

    def __init__(self, inputs, states, out_state=None, name=None):
        self._state_names = list(states)
        self._init_states = dict(states)
        self._cur_states = {}
        self._input_names = list(inputs)
        self._cur_inputs = dict(inputs)
        self._out_state_name = out_state or (
            self._state_names[0] if self._state_names else None)
        self._updater = None

    def state_updater(self, updater):
        """Decorator registering the step function updater(cell)."""
        self._updater = updater
        return updater

    def get_state(self, name):
        if name in self._cur_states:
            return self._cur_states[name]
        init = self._init_states[name]
        return init.value if isinstance(init, InitState) else init

    def set_state(self, name, value):
        self._cur_states[name] = value

    def get_input(self, name):
        v = self._cur_inputs.get(name)
        if v is None:
            raise KeyError(f"StateCell input {name!r} not set this step")
        return v

    def compute_state(self, inputs):
        """Run the updater for one step on these inputs."""
        if self._updater is None:
            raise RuntimeError("StateCell has no updater; register one "
                               "with @state_cell.state_updater")
        self._cur_inputs = dict(inputs)
        self._updater(self)

    def update_states(self):
        """Commit the step's states: the unrolled steps keep them in the
        cell already (the reference's call, kept for its flow)."""
        return None

    def out_state(self):
        return self.get_state(self._out_state_name)

    def _all_state_names(self):
        return self._state_names + [n for n in self._cur_states
                                    if n not in self._state_names]


class TrainingDecoder:
    """The teacher-forced decoder, unrolled over the time axis of its
    step input:

        with decoder.block():
            x_t = decoder.step_input(trg_embedding)   # [B, T, D]
            cell.compute_state({'x': x_t})
            decoder.output(cell.out_state())
            cell.update_states()
        out = decoder()                               # [B, T, H]

    The block's body runs once, for step 0; __call__ replays the updater
    for steps 1..T-1, so every output must be a cell state."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._state_cell = state_cell
        self._status = self.BEFORE_DECODER
        self._step_inputs = []
        self._static_inputs = []
        self._outputs_per_step = []
        self._output_state_names = []

    @contextlib.contextmanager
    def block(self):
        """The step body, recorded at step 0."""
        self._status = self.IN_DECODER
        try:
            yield
        finally:
            self._status = self.AFTER_DECODER

    def step_input(self, x):
        """x [B, T, ...] as a step input: returns step 0's slice."""
        if self._status != self.IN_DECODER:
            raise RuntimeError("step_input only valid inside block()")
        self._step_inputs.append(x)
        return self._slice_t(x, 0)

    def static_input(self, x):
        """x shared by every step (an encoder output)."""
        self._static_inputs.append(x)
        return x

    def output(self, *outputs):
        """The step's outputs: each must be a StateCell state (derived
        values set with cell.set_state in the updater), since the unroll
        replays the updater alone."""
        cell = self._state_cell
        self._output_state_names = []
        for o in outputs:
            matched = next((n for n in cell._all_state_names()
                            if cell.get_state(n) is o), None)
            if matched is None:
                raise ValueError(
                    "TrainingDecoder.output: each output must be a "
                    "StateCell state (use cell.set_state('name', v) "
                    "inside the updater for derived values): the static "
                    "unroll replays only the updater each step")
            self._output_state_names.append(matched)
        self._outputs_per_step = list(outputs)

    @staticmethod
    def _slice_t(x, t):
        sliced = layers.slice(x, axes=[1], starts=[t], ends=[t + 1])
        return layers.squeeze(sliced, axes=[1])

    def __call__(self):
        """The outputs of every step, stacked on axis 1."""
        if not self._step_inputs or not self._outputs_per_step:
            raise RuntimeError("TrainingDecoder needs step_input() and "
                               "output() inside block()")
        cell = self._state_cell
        T = int(self._step_inputs[0].shape[1])
        outs = [[layers.unsqueeze(o, axes=[1])
                 for o in self._outputs_per_step]]
        for t in range(1, T):
            cell.compute_state({name: self._slice_t(x, t)
                                for name, x in zip(cell._input_names,
                                                   self._step_inputs)})
            cell.update_states()
            outs.append([layers.unsqueeze(cell.get_state(n), axes=[1])
                         for n in self._output_state_names])
        stacked = [layers.concat([o[i] for o in outs], axis=1)
                   for i in range(len(outs[0]))]
        return stacked[0] if len(stacked) == 1 else stacked


class BeamSearchDecoder:
    """Beam search over a StateCell, unrolled to `max_len` steps. Each
    step embeds the previous ids ('<name>_emb.w_0'), runs the cell,
    scores the vocabulary (an fc with softmax, '<name>_fc.{w,b}_0'),
    takes the top `topk_size`, adds their log to the beam's score and
    selects with beam_search; every state and carried input follows its
    parent row (gather). A finished beam is frozen, so the steps after
    every beam ended change nothing: early_stop() has nothing to do.

        decoder = BeamSearchDecoder(cell, init_ids, init_scores,
                                    target_dict_dim=V, word_dim=E, ...)
        decoder.decode()
        translation_ids, translation_scores = decoder()
    """

    BEFORE_BEAM_SEARCH_DECODER = 0
    IN_BEAM_SEARCH_DECODER = 1
    AFTER_BEAM_SEARCH_DECODER = 2

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50,
                 sparse_emb=True, max_len=100, beam_size=1, end_id=1,
                 name=None):
        self._state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = int(target_dict_dim)
        self._word_dim = int(word_dim)
        self._input_var_dict = dict(input_var_dict or {})
        self._topk_size = min(int(topk_size), int(target_dict_dim))
        self._sparse_emb = bool(sparse_emb)
        self._max_len = int(max_len)
        self._beam_size = int(beam_size)
        self._end_id = int(end_id)
        self._name = name or "beam_search_decoder"
        self._status = self.BEFORE_BEAM_SEARCH_DECODER
        self._arrays = {}
        self._result = None

    @contextlib.contextmanager
    def block(self):
        """The decode body; entered once."""
        if self._status != self.BEFORE_BEAM_SEARCH_DECODER:
            raise ValueError("block() can only be invoked once.")
        self._status = self.IN_BEAM_SEARCH_DECODER
        try:
            yield
        finally:
            self._status = self.AFTER_BEAM_SEARCH_DECODER

    def read_array(self, init, is_ids=False, is_scores=False):
        """The current value of a step-carried var, `init` at first."""
        if is_ids and is_scores:
            raise ValueError("an array cannot be both the ids and the "
                             "scores array")
        return self._arrays.setdefault(init.name, init)

    def update_array(self, array_value, new_value):
        """The next step's value of a carried var."""
        for key, cur in list(self._arrays.items()):
            if cur is array_value:
                self._arrays[key] = new_value
                return
        raise ValueError("update_array target was not produced by "
                         "read_array")

    def early_stop(self):
        """Nothing to do: finished beams are frozen."""

    def decode(self):
        """Build the beam decode."""
        cell = self._state_cell
        K, end_id = self._beam_size, self._end_id
        with self.block():
            prev_ids = self.read_array(self._init_ids, is_ids=True)
            prev_scores = self.read_array(self._init_scores,
                                          is_scores=True)
            carried = {n: self.read_array(v)
                       for n, v in self._input_var_dict.items()}
            for n in carried:
                if n not in cell._input_names:
                    raise ValueError(f"Variable {n!r} not found in "
                                     f"StateCell!")
            ids_hist, score_hist, parent_hist = [], [], []
            for _ in range(self._max_len):
                emb = layers.embedding(
                    prev_ids, size=[self._target_dict_dim, self._word_dim],
                    is_sparse=self._sparse_emb, dtype="float32",
                    param_attr=ParamAttr(name=self._name + "_emb.w_0"))
                feed = dict(carried)
                for n in cell._input_names:
                    feed.setdefault(n, emb)
                cell.compute_state(inputs=feed)
                probs = layers.fc(
                    cell.out_state(), self._target_dict_dim, act="softmax",
                    param_attr=ParamAttr(name=self._name + "_fc.w_0"),
                    bias_attr=ParamAttr(name=self._name + "_fc.b_0"))
                topk_scores, topk_idx = layers.topk(probs,
                                                    k=self._topk_size)
                accu = layers.elementwise_add(layers.log(topk_scores),
                                              prev_scores)
                sel_ids, sel_scores, parent = layers.beam_search(
                    prev_ids, prev_scores, topk_idx, accu, K,
                    end_id=end_id, return_parent_idx=True)
                for sname in cell._all_state_names():
                    cell.set_state(sname, layers.gather(
                        cell.get_state(sname), parent))
                cell.update_states()
                for n, v in carried.items():
                    nv = layers.gather(v, parent)
                    self.update_array(v, nv)
                    carried[n] = nv
                self.update_array(prev_ids, sel_ids)
                self.update_array(prev_scores, sel_scores)
                prev_ids, prev_scores = sel_ids, sel_scores
                ids_hist.append(sel_ids)
                score_hist.append(sel_scores)
                parent_hist.append(parent)
            self._result = layers.beam_search_decode(
                layers.stack(ids_hist, axis=0),
                layers.stack(score_hist, axis=0),
                layers.stack(parent_hist, axis=0), beam_size=K,
                end_id=end_id)

    def __call__(self):
        """(translation_ids [B*K, T], translation_scores [B*K, 1])."""
        if self._result is None:
            raise RuntimeError("call decode() before the decoder")
        return self._result

"""User-definable RNN decoder API (port of
``paddle_tpu/contrib/decoder/beam_search_decoder.py``; parity with
python/paddle/fluid/contrib/decoder/beam_search_decoder.py: InitState /
StateCell / TrainingDecoder / BeamSearchDecoder).

The reference drives a While op over LoD beams with array read/write
plumbing. Here, as in the JAX package, the same four-class API builds
on the dense fixed-shape machinery: the TrainingDecoder is a DynamicRNN
(a ``scan`` with sequence masks), and BeamSearchDecoder.decode() is a
StaticRNN over ``max_len`` steps whose body runs the user's StateCell
update on [batch*beam] rows, expands with topk, steps the dense
``beam_search`` op, gathers states by parent-beam index, and finally
backtracks with ``beam_search_decode`` — one loop of ``max_len`` steps
with no host read.
"""
from ... import layers
from ...layers import control_flow

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState:
    """Initial hidden state: an existing variable, or a constant tensor
    shaped like ``init_boot`` (reference beam_search_decoder.py:43).
    ``need_reorder`` is accepted for parity; the padded representation
    never length-sorts batches so it is a no-op here."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                "init_boot must be provided to infer the shape of "
                "InitState .\n")
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape or [-1, 1],
                dtype=dtype)
        self._need_reorder = need_reorder

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class StateCell:
    """Named states + named per-step inputs + a user-registered updater
    (reference beam_search_decoder.py:159). The updater reads inputs
    and current states with ``get_input``/``get_state``, computes, and
    commits with ``set_state``; the enclosing decoder decides how
    states persist across steps."""

    def __init__(self, inputs, states, out_state, name=None):
        self._inputs = dict(inputs)        # name -> placeholder (or None)
        self._init_states = dict(states)   # name -> InitState
        self._state_names = list(states)
        self._cur_states = {}              # name -> current Variable
        self._next_states = {}             # staged updates
        self._updater = None
        self._out_state_name = out_state
        self._decoder = None
        # standalone use (no decoder): states start at their init value
        for name, init_state in self._init_states.items():
            self._cur_states[name] = init_state.value

    # -- wiring --------------------------------------------------------
    def _enter_decoder(self, decoder):
        self._decoder = decoder

    def _leave_decoder(self, decoder):
        if self._decoder is decoder:
            self._decoder = None

    def state_updater(self, updater):
        """Decorator registering the per-step update function
        ``updater(state_cell)``."""
        self._updater = updater

        def _decorator(state_cell):
            if state_cell is not self:
                raise TypeError("updater bound to a different StateCell")
            updater(state_cell)
        return _decorator

    # -- accessors the updater uses ------------------------------------
    def get_state(self, state_name):
        if state_name not in self._cur_states:
            raise ValueError(f"unknown state {state_name!r}")
        return self._cur_states[state_name]

    def get_input(self, input_name):
        if input_name not in self._inputs or \
                self._inputs[input_name] is None:
            raise ValueError(f"input {input_name!r} has not been set")
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        if state_name not in self._init_states:
            raise ValueError(f"unknown state {state_name!r}")
        self._next_states[state_name] = state_value

    # -- driving -------------------------------------------------------
    def compute_state(self, inputs):
        """Run the updater with this step's ``inputs`` (dict
        name -> Variable)."""
        if self._updater is None:
            raise ValueError("no state_updater registered")
        for name, value in inputs.items():
            if name not in self._inputs:
                raise ValueError(f"unknown input {name!r}")
            self._inputs[name] = value
        self._next_states = {}
        self._updater(self)

    def update_states(self):
        """Commit staged states — inside a TrainingDecoder this links
        the DynamicRNN memories; standalone it just advances."""
        for name, value in self._next_states.items():
            if self._decoder is not None and \
                    self._decoder.type == _DecoderType.TRAINING:
                self._decoder.dynamic_rnn.update_memory(
                    self._cur_states[name], value)
            self._cur_states[name] = value
        self._next_states = {}

    def out_state(self):
        return self._cur_states[self._out_state_name]


class TrainingDecoder:
    """Teacher-forced decoder over target sequences — the reference's
    DynamicRNN wrapper (beam_search_decoder.py:384)."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._dynamic_rnn = control_flow.DynamicRNN(name=name)
        self._type = _DecoderType.TRAINING
        self._status = TrainingDecoder.BEFORE_DECODER

    @property
    def state_cell(self):
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._dynamic_rnn

    @property
    def type(self):
        return self._type

    def block(self):
        """``with decoder.block():`` — the per-timestep body."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            self._status = TrainingDecoder.IN_DECODER
            with self._dynamic_rnn.block():
                # states become scan memories initialized from InitState
                for name in self._state_cell._state_names:
                    init = self._state_cell._init_states[name]
                    mem = self._dynamic_rnn.memory(init=init.value)
                    self._state_cell._cur_states[name] = mem
                yield
            self._status = TrainingDecoder.AFTER_DECODER
            self._state_cell._leave_decoder(self)
        return _ctx()

    def step_input(self, x):
        self._assert_in_decoder_block("step_input")
        return self._dynamic_rnn.step_input(x)

    def static_input(self, x):
        """Non-sequence input visible at every step: the scan's step
        reads outer-block variables directly."""
        self._assert_in_decoder_block("static_input")
        return x

    def output(self, *outputs):
        self._assert_in_decoder_block("output")
        self._dynamic_rnn.output(*outputs)

    def __call__(self, *args, **kwargs):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError(
                "output of TrainingDecoder may only be visited outside "
                "the block")
        return self._dynamic_rnn(*args, **kwargs)

    def _assert_in_decoder_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError(
                f"{method} should be invoked inside block of "
                "TrainingDecoder object.")


class BeamSearchDecoder:
    """Beam-search inference decoder over a StateCell (reference
    beam_search_decoder.py:523). ``decode()`` builds the default
    computation; calling the decoder returns
    (translation_ids [batch, beam, max_len],
     translation_scores [batch, beam])."""

    def __init__(self, state_cell, init_ids, init_scores,
                 target_dict_dim, word_dim, input_var_dict=None,
                 topk_size=50, sparse_emb=True, max_len=100, beam_size=1,
                 end_id=1, name=None):
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._type = _DecoderType.BEAM_SEARCH
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = input_var_dict or {}
        self._topk_size = min(topk_size, target_dict_dim)
        self._sparse_emb = sparse_emb
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        # a unique default prefix — two unnamed decoders in one program
        # must not silently share their embedding/projection weights
        if name is None:
            from ...core import unique_name
            name = unique_name.generate("bsd")
        self._name = name
        self._outputs = None

    @property
    def type(self):
        return self._type

    def decode(self):
        """Default decode graph. Dense [batch, beam] beams: beam 0
        seeds from init_ids/init_scores, the rest start at -inf so the
        first expansion populates them; each step embeds the previous
        ids, runs the StateCell on [batch*beam] rows, scores with a
        softmax projection, pre-selects top-k, then the dense
        ``beam_search`` op picks the next beams and parent indices;
        states gather by parent. Finished beams (end_id) freeze."""
        beam = self._beam_size
        ids0 = layers.cast(layers.reshape(self._init_ids, [-1, 1]),
                           "int64")
        # [batch, beam] starting ids: every beam starts at init id
        prev_ids0 = layers.expand(ids0, [1, beam])
        scores0 = layers.reshape(
            layers.cast(self._init_scores, "float32"), [-1, 1])
        # beam 0 active, the rest silenced with -1e9
        import numpy as np
        silence = layers.assign(
            np.asarray([[0.0] + [-1e9] * (beam - 1)], np.float32))
        prev_scores0 = layers.elementwise_add(
            layers.expand(scores0, [1, beam]), silence)

        rnn = control_flow.StaticRNN(name=self._name)
        steps = layers.fill_constant_batch_size_like(
            input=ids0, shape=[-1, self._max_len, 1], dtype="float32",
            value=0.0)
        expanded_statics = {}
        for name, var in self._input_var_dict.items():
            if name not in self._state_cell._inputs:
                raise ValueError(
                    f"Variable {name} not found in StateCell!\n")
            # beam-expand rows once, outside the scan: [b, ...] ->
            # [b*beam, ...] repeating each row beam times
            expanded_statics[name] = layers.beam_expand(var, beam)
        # memory inits run once, before the scan — expand them here in
        # the parent block, not inside the step sub-block
        expanded_inits = {
            sname: layers.beam_expand(
                self._state_cell._init_states[sname].value, beam)
            for sname in self._state_cell._state_names}

        with rnn.step():
            _ = rnn.step_input(steps)
            prev_ids = rnn.memory(init=prev_ids0)          # [b, beam]
            prev_scores = rnn.memory(init=prev_scores0)    # [b, beam]
            state_mems = {}
            for sname in self._state_cell._state_names:
                mem = rnn.memory(init=expanded_inits[sname])
                state_mems[sname] = mem                    # [b*beam, H]
                self._state_cell._cur_states[sname] = mem

            flat_ids = layers.reshape(layers.cast(prev_ids, "int64"),
                                      [-1, 1])
            emb = layers.embedding(
                flat_ids, size=[self._target_dict_dim, self._word_dim],
                dtype="float32", is_sparse=self._sparse_emb,
                param_attr=f"{self._name}_emb")

            defaulted = [n for n in self._state_cell._inputs
                         if n not in expanded_statics]
            if len(defaulted) > 1:
                raise ValueError(
                    "StateCell has multiple inputs "
                    f"{sorted(defaulted)} not covered by "
                    "input_var_dict — only ONE input may default to "
                    "the previous-token embedding")
            feed_dict = {}
            for iname in self._state_cell._inputs:
                feed_dict[iname] = expanded_statics.get(iname, emb)
            self._state_cell.compute_state(inputs=feed_dict)
            self._state_cell.update_states()

            cur = self._state_cell.out_state()             # [b*beam, H]
            logits = layers.fc(cur, size=self._target_dict_dim,
                               param_attr=f"{self._name}_score_w",
                               bias_attr=f"{self._name}_score_b")
            probs = layers.softmax(logits)
            topk_scores, topk_idx = layers.topk(probs, k=self._topk_size)
            accu = layers.elementwise_add(
                layers.reshape(layers.log(topk_scores),
                               [-1, beam, self._topk_size]),
                layers.unsqueeze(prev_scores, axes=[2]))
            cand_ids = layers.reshape(topk_idx,
                                      [-1, beam, self._topk_size])
            sel_ids, sel_scores, parent = layers.beam_search(
                prev_ids, prev_scores, cand_ids, accu, beam,
                end_id=self._end_id)

            # pull each selected beam's state from its parent beam
            for sname, mem in state_mems.items():
                gathered = layers.beam_gather(
                    self._state_cell._cur_states[sname], parent)
                rnn.update_memory(mem, gathered)
            rnn.update_memory(prev_ids, layers.cast(sel_ids, "int64"))
            rnn.update_memory(prev_scores, sel_scores)
            rnn.step_output(sel_ids)
            rnn.step_output(parent)
            rnn.step_output(sel_scores)

        step_ids, step_parents, step_scores = rnn()
        # [batch, T, beam] -> [T, batch, beam] stacks for the decoder op
        step_ids = layers.transpose(step_ids, perm=[1, 0, 2])
        step_parents = layers.transpose(step_parents, perm=[1, 0, 2])
        final_scores = layers.slice(
            step_scores, axes=[1], starts=[self._max_len - 1],
            ends=[self._max_len])
        final_scores = layers.reshape(final_scores, [-1, beam])
        sent_ids, sent_scores = layers.beam_search_decode(
            (step_ids, step_parents), final_scores, beam,
            end_id=self._end_id)
        self._outputs = (sent_ids, sent_scores)
        self._state_cell._leave_decoder(self)
        return self._outputs

    def early_stop(self):
        """Parity shim: the dense scan always runs max_len steps;
        finished beams freeze via end_id propagation instead."""

    def __call__(self):
        if self._outputs is None:
            raise ValueError("decode() must be called before the "
                             "decoder output is read")
        return self._outputs

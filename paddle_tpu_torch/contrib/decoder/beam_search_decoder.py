"""The seq2seq decoder API: ``InitState`` / ``StateCell`` /
``TrainingDecoder`` / ``BeamSearchDecoder`` (counterpart of
``paddle_tpu/contrib/decoder/beam_search_decoder.py``, the same surface
and the same programs).

* Beams are a fixed ``[B, K]`` lane dimension for the whole search;
  finished beams are frozen by the ``beam_search`` op (they re-emit
  ``end_id`` at no cost) instead of being pruned.  The first expansion
  grows out of beam 0 only: the other lanes start at a score of -1e9
  (the lane penalty).
* Hidden states are ``While`` carries of static shape ``[B, K*S]``; the
  beam-parent gathers are one-hot products (``one_hot`` of the parents,
  then ``matmul``).
* Per-step ids and parents land in ``[max_len, B, K]`` arrays made
  beforehand as a frozen tail (``end_id`` tokens, identity parents), so
  an ``early_stop()`` or the all-finished exit leaves them valid for
  ``beam_search_decode``'s backtrack.
* ``decode()`` stops the loop when every selected id is ``end_id`` or
  after ``max_len`` steps; the loop is an unbounded ``While``, so on the
  card the executor replays its body graph until the condition falls.
* ``topk_size`` is accepted for the API and unused: ``beam_search``
  takes the top K of the whole vocabulary.

``StateCell`` drives a ``DynamicRNN`` memory when entered by a
``TrainingDecoder`` and a loop carry when entered by a
``BeamSearchDecoder``, so one updater function serves training and
search.
"""

import contextlib

import numpy as np

from ... import unique_name
from ...framework import Variable
from ...layer_helper import LayerHelper
from ... import layers

__all__ = ['InitState', 'StateCell', 'TrainingDecoder', 'BeamSearchDecoder']


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState(object):
    """Initial hidden state for one ``StateCell`` state: an explicit
    ``init`` Variable or a constant tensor shaped like ``init_boot``'s
    batch.  ``need_reorder`` is accepted and unused: padded batches keep
    their order.
    """

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype='float32'):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                'init_boot must be provided to infer the shape of InitState')
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, shape=shape, value=value, dtype=dtype)
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class _MemoryState(object):
    """Training-side state: a DynamicRNN memory."""

    def __init__(self, state_name, rnn_obj, init_state):
        self._state_name = state_name
        self._rnn_obj = rnn_obj
        self._state_mem = self._rnn_obj.memory(init=init_state.value)

    def get_state(self):
        return self._state_mem

    def update_state(self, state):
        self._rnn_obj.update_memory(self._state_mem, state)


class _BeamState(object):
    """Search-side state: a ``[B, K*S]`` While-loop carry.

    ``get_state`` exposes the beam-flattened ``[B*K, S]`` view;
    ``update_state`` records the step's computed state, which the
    decoder reorders by the chosen beam parents and assigns back into
    the carry."""

    def __init__(self, state_name, decoder, init_state):
        init = init_state.value
        if len(init.shape) != 2:
            raise ValueError(
                'BeamSearchDecoder states must be rank-2 [batch, size]; '
                'state %r has shape %s' % (state_name, (init.shape,)))
        self._state_name = state_name
        self._decoder = decoder
        self._size = int(init.shape[1])
        k = decoder._beam_size
        # The carry must be a loop-carried var: its init/tile ops belong
        # in the block that owns the While op, but _BeamState is built
        # lazily at the first in-loop state access: emit into the
        # decoder's parent block explicitly.
        program = decoder._helper.main_program
        saved = program.current_block_idx
        program.current_block_idx = decoder._parent_block.idx
        try:
            # [B, S] -> [B, K, S] -> [B, K*S]
            tiled = layers.expand(
                layers.unsqueeze(init, axes=[1]), expand_times=[1, k, 1])
            self._carry = layers.reshape(tiled, shape=[0, k * self._size])
        finally:
            program.current_block_idx = saved
        self._pending = None

    def get_state(self):
        # in-loop flattened view [B*K, S]
        return layers.reshape(self._carry, shape=[-1, self._size])

    def update_state(self, state):
        self._pending = state
        # when the beam parents for this step are already known (the
        # standard search-then-update order), gather immediately; a
        # custom update-then-search order is flushed by search_step
        if self._decoder._parent_onehot is not None:
            self.commit(self._decoder._parent_onehot)

    def commit(self, parent_onehot):
        """Gather the pending state by beam parent and write the carry."""
        if self._pending is None:
            return
        k = self._decoder._beam_size
        s3 = layers.reshape(self._pending, shape=[-1, k, self._size])
        sel = layers.matmul(parent_onehot, s3)            # [B, K, S]
        layers.assign(layers.reshape(sel, shape=[0, k * self._size]),
                      output=self._carry)
        self._pending = None


class StateCell(object):
    """Named hidden states + step inputs of an RNN cell.  The cell's step
    function is installed
    with ``state_updater`` and runs identically under a
    ``TrainingDecoder`` (states are DynamicRNN memories) and a
    ``BeamSearchDecoder`` (states are beam-search loop carries)."""

    def __init__(self, inputs, states, out_state, name=None):
        self._helper = LayerHelper('state_cell', name=name)
        self._cur_states = {}
        self._init_states = {}   # preserved across decoders (a cell may
        self._state_names = []   # serve a TrainingDecoder then a search)
        for state_name, state in states.items():
            if not isinstance(state, InitState):
                raise ValueError('state must be an InitState object.')
            self._cur_states[state_name] = state
            self._init_states[state_name] = state
            self._state_names.append(state_name)
        self._inputs = inputs
        self._cur_decoder_obj = None
        self._in_decoder = False
        self._states_holder = {}
        self._switched_decoder = False
        self._state_updater = None
        self._out_state = out_state
        if self._out_state not in self._cur_states:
            raise ValueError('out_state must be one state in states')

    def _enter_decoder(self, decoder_obj):
        if self._in_decoder or self._cur_decoder_obj is not None:
            raise ValueError('StateCell has already entered a decoder.')
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj
        self._switched_decoder = False

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder:
            raise ValueError('StateCell not in decoder, '
                             'invalid leaving operation.')
        if self._cur_decoder_obj is not decoder_obj:
            raise ValueError('Inconsistent decoder object in StateCell.')
        self._in_decoder = False
        self._cur_decoder_obj = None
        self._switched_decoder = False

    def _switch_decoder(self):
        """Lazily bind each InitState to the entered decoder's state
        mechanism (memory vs loop carry) on first access."""
        if not self._in_decoder:
            raise ValueError('StateCell must enter a decoder first.')
        if self._switched_decoder:
            raise ValueError('StateCell already done switching.')
        for state_name in self._state_names:
            holder = self._states_holder.setdefault(state_name, {})
            if id(self._cur_decoder_obj) not in holder:
                state = self._init_states[state_name]
                if self._cur_decoder_obj.type == _DecoderType.TRAINING:
                    holder[id(self._cur_decoder_obj)] = _MemoryState(
                        state_name, self._cur_decoder_obj.dynamic_rnn,
                        state)
                elif self._cur_decoder_obj.type == _DecoderType.BEAM_SEARCH:
                    holder[id(self._cur_decoder_obj)] = _BeamState(
                        state_name, self._cur_decoder_obj, state)
                else:
                    raise ValueError('Unknown decoder type, only support '
                                     '[TRAINING, BEAM_SEARCH]')
            self._cur_states[state_name] = holder[
                id(self._cur_decoder_obj)].get_state()
        self._switched_decoder = True

    def get_state(self, state_name):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        if state_name not in self._cur_states:
            raise ValueError('Unknown state %s.' % state_name)
        return self._cur_states[state_name]

    def get_input(self, input_name):
        if input_name not in self._inputs or \
                self._inputs[input_name] is None:
            raise ValueError('Invalid input %s.' % input_name)
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        self._cur_states[state_name] = state_value

    def state_updater(self, updater):
        """Install the cell step function (usable as a decorator).  The
        updater receives this StateCell and must ``set_state`` every
        state it advances."""
        self._state_updater = updater
        return updater

    def compute_state(self, inputs):
        """Bind this step's inputs and run the installed updater."""
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for input_name, input_value in inputs.items():
            if input_name not in self._inputs:
                raise ValueError(
                    'Unknown input %s. Please make sure %s is a declared '
                    'input placeholder.' % (input_name, input_name))
            self._inputs[input_name] = input_value
        if self._state_updater is None:
            raise ValueError('state_updater has not been installed.')
        self._state_updater(self)

    def update_states(self):
        """Record the step's computed states into the decoder's state
        mechanism (RNN memory update / beam carry commit)."""
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for state_name, decoder_state in self._states_holder.items():
            if id(self._cur_decoder_obj) not in decoder_state:
                raise ValueError('Unknown decoder object, please make sure '
                                 'switch_decoder has been invoked.')
            decoder_state[id(self._cur_decoder_obj)].update_state(
                self._cur_states[state_name])

    def out_state(self):
        return self._cur_states[self._out_state]


class TrainingDecoder(object):
    """Teacher-forced decoder: a DynamicRNN over the target sequence
    driving a StateCell."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._helper = LayerHelper('training_decoder', name=name)
        self._status = TrainingDecoder.BEFORE_DECODER
        self._dynamic_rnn = layers.DynamicRNN()
        self._type = _DecoderType.TRAINING
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)

    @contextlib.contextmanager
    def block(self):
        if self._status != TrainingDecoder.BEFORE_DECODER:
            raise ValueError('decoder.block() can only be invoked once')
        self._status = TrainingDecoder.IN_DECODER
        with self._dynamic_rnn.block():
            yield
        self._status = TrainingDecoder.AFTER_DECODER
        self._state_cell._leave_decoder(self)

    @property
    def state_cell(self):
        self._assert_in_decoder_block('state_cell')
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._dynamic_rnn

    @property
    def type(self):
        return self._type

    def step_input(self, x):
        self._assert_in_decoder_block('step_input')
        return self._dynamic_rnn.step_input(x)

    def static_input(self, x):
        self._assert_in_decoder_block('static_input')
        return self._dynamic_rnn.static_input(x)

    def __call__(self, *args, **kwargs):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError('Output of training decoder can only be visited '
                             'outside the block.')
        return self._dynamic_rnn(*args, **kwargs)

    def output(self, *outputs):
        self._assert_in_decoder_block('output')
        self._dynamic_rnn.output(*outputs)

    def _assert_in_decoder_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError('%s should be invoked inside block of '
                             'TrainingDecoder object.' % method)


class BeamSearchDecoder(object):
    """Beam-search generation: fixed ``[B, K]`` beams in a ``While``
    loop of at most ``max_len`` trips (module docstring).

    The trailing ``*_attr`` args let the search share parameters with
    the training program by name.
    """

    BEFORE_BEAM_SEARCH_DECODER = 0
    IN_BEAM_SEARCH_DECODER = 1
    AFTER_BEAM_SEARCH_DECODER = 2

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict={}, topk_size=50, sparse_emb=True,
                 max_len=100, beam_size=1, end_id=1, name=None,
                 emb_param_attr=None, score_param_attr=None,
                 score_bias_attr=None):
        self._helper = LayerHelper('beam_search_decoder', name=name)
        self._parent_block = self._helper.main_program.current_block()
        self._type = _DecoderType.BEAM_SEARCH
        self._status = BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER
        self._state_cell = state_cell
        self._max_len = int(max_len)
        self._beam_size = int(beam_size)
        self._end_id = int(end_id)
        self._target_dict_dim = int(target_dict_dim)
        self._word_dim = int(word_dim)
        self._topk_size = int(topk_size)   # parity only; see module doc
        self._sparse_emb = sparse_emb
        self._input_var_dict = input_var_dict
        self._emb_param_attr = emb_param_attr
        self._score_param_attr = score_param_attr
        self._score_bias_attr = score_bias_attr

        k = self._beam_size

        def _like(shape, value, dtype, out_dim=0):
            return layers.fill_constant_batch_size_like(
                input=init_ids, shape=shape, dtype=dtype, value=value,
                input_dim_idx=0, output_dim_idx=out_dim)

        # beam carries: ids [B, K] seeded from init_ids' first column;
        # scores [B, K] = init score on beam 0, -inf elsewhere so the
        # first expansion grows out of beam 0 only
        first_ids = layers.reshape(
            layers.slice(init_ids, axes=[1], starts=[0], ends=[1]),
            shape=[-1, 1])
        self._cur_ids = layers.elementwise_add(
            _like([-1, k], 0, 'int64'),
            layers.cast(first_ids, 'int64'))
        lane_penalty = np.zeros((1, k), dtype='float32')
        lane_penalty[0, 1:] = -1e9
        first_scores = layers.cast(
            layers.reshape(
                layers.slice(init_scores, axes=[1], starts=[0], ends=[1]),
                shape=[-1, 1]), 'float32')
        self._cur_scores = layers.elementwise_add(
            layers.elementwise_add(_like([-1, k], 0.0, 'float32'),
                                   layers.assign(lane_penalty)),
            first_scores)

        # step arrays preinitialized to a FROZEN tail: end_id tokens with
        # identity parents, so an early_stop() exit leaves every
        # unwritten step a valid no-op link for backtracking
        self._ids_array = _like([self._max_len, -1, k],
                                float(self._end_id), 'int64', out_dim=1)
        self._parents_array = layers.elementwise_add(
            _like([self._max_len, -1, k], 0, 'int64', out_dim=1),
            layers.assign(np.arange(k, dtype='int64').reshape(1, 1, k)))

        self._counter = layers.fill_constant(
            shape=[1], dtype='int64', value=0)
        self._counter.stop_gradient = True
        self._max_len_var = layers.fill_constant(
            shape=[1], dtype='int64', value=self._max_len)
        self._cond = layers.less_than(self._counter, self._max_len_var)
        self._while_op = layers.While(self._cond)

        self._array_dict = {}
        self._array_link = []
        self._parent_onehot = None
        self._state_cell._enter_decoder(self)

    @property
    def type(self):
        return self._type

    @property
    def state_cell(self):
        self._assert_in_decoder_block('state_cell')
        return self._state_cell

    @contextlib.contextmanager
    def block(self):
        """The per-step search block.  On exit: flush scheduled array
        writes at the current step index, advance the counter, and
        refresh the loop condition."""
        if self._status != BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER:
            raise ValueError('block() can only be invoked once.')
        self._status = BeamSearchDecoder.IN_BEAM_SEARCH_DECODER
        with self._while_op.block():
            yield
            for value, array in self._array_link:
                layers.assign(
                    layers.array_write(value, self._counter, array=array),
                    output=array)
            layers.increment(self._counter, value=1)
            refreshed = layers.less_than(self._counter, self._max_len_var)
            layers.assign(layers.logical_and(self._cond, refreshed),
                          output=self._cond)
        self._status = BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER
        self._state_cell._leave_decoder(self)

    def early_stop(self):
        """Terminate the search before ``max_len`` steps ("break")."""
        self._assert_in_decoder_block('early_stop')
        layers.assign(
            layers.fill_constant(shape=[1], dtype='bool', value=0),
            output=self._cond)

    def read_array(self, init, is_ids=False, is_scores=False):
        """Expose ``init`` as a per-step carried value; returns the
        current step's view.  With fixed beams the carry is the value, so
        this returns the carried Variable (``update_array`` writes the
        next step's value into it)."""
        self._assert_in_decoder_block('read_array')
        if is_ids and is_scores:
            raise ValueError('An array cannot be both ids and scores.')
        if not isinstance(init, Variable):
            raise TypeError('The input argument `init` must be a Variable.')
        if is_ids:
            read_value = self._cur_ids
        elif is_scores:
            read_value = self._cur_scores
        else:
            read_value = init
        self._array_dict[read_value.name] = read_value
        return read_value

    def update_array(self, array, value):
        """Carry ``value`` into the next step's ``read_array`` view."""
        self._assert_in_decoder_block('update_array')
        if not isinstance(array, Variable):
            raise TypeError('The input argument `array` must be a Variable.')
        if not isinstance(value, Variable):
            raise TypeError('The input argument `value` must be a Variable.')
        carried = self._array_dict.get(array.name, None)
        if carried is None:
            raise ValueError('Please invoke read_array before update_array.')
        layers.assign(value, output=carried)

    def search_step(self, log_probs):
        """Expand beams with this step's ``[B*K, V]`` (or ``[B, K, V]``)
        log-probabilities: runs the ``beam_search`` op, records
        ids/backpointers for decode-time backtracking, updates the
        ids/scores carries, and remembers the parent gather for
        ``update_states`` to commit hidden states.  Returns
        (selected_ids [B, K], selected_scores [B, K])."""
        self._assert_in_decoder_block('search_step')
        k = self._beam_size
        if len(log_probs.shape) == 2:
            log_probs = layers.reshape(
                log_probs, shape=[-1, k, int(log_probs.shape[-1])])
        sel_ids, sel_scores, parent = layers.beam_search(
            self._cur_ids, self._cur_scores, log_probs,
            beam_size=k, end_id=self._end_id)
        self._parent_onehot = layers.one_hot(
            layers.unsqueeze(parent, axes=[2]), depth=k)      # [B, K, K]
        self._array_link = [(sel_ids, self._ids_array),
                            (parent, self._parents_array)]
        layers.assign(sel_ids, output=self._cur_ids)
        layers.assign(sel_scores, output=self._cur_scores)
        # flush states updated BEFORE this search (custom decoders that
        # call update_states first); they gather by this step's parents
        for holder in self._state_cell._states_holder.values():
            state = holder.get(id(self))
            if state is not None and state._pending is not None:
                state.commit(self._parent_onehot)
        return sel_ids, sel_scores

    def commit_states(self):
        """Gather every pending hidden state by the beam parents chosen
        in ``search_step`` and write the loop carries."""
        self._assert_in_decoder_block('commit_states')
        if self._parent_onehot is None:
            raise ValueError('commit_states requires a prior search_step.')
        for holder in self._state_cell._states_holder.values():
            state = holder.get(id(self))
            if state is not None:
                state.commit(self._parent_onehot)

    def decode(self):
        """The standard search loop (override for a custom decoder):
        embed the previous tokens, advance the StateCell, score with a
        softmax projection, expand beams, stop early once every beam
        has emitted ``end_id``."""
        # tile per-sentence inputs across the K beam lanes OUTSIDE the
        # loop (they are step-invariant; outer vars are readable inside
        # the block): [B, d1, ..., dn] -> [B*K, d1, ..., dn] (e.g. an
        # encoder sequence [B, T, H] an attention cell reads).  Tiled by
        # a batch-index gather (row b repeats K times) rather than
        # expand+reshape: trailing dims of RNN outputs are unknown at
        # build time, and gather never needs them.
        feed_dict = {}
        k = self._beam_size
        idx = None   # one shared [B*K] index: every entry has batch B
        for name, var in self._input_var_dict.items():
            if name not in self._state_cell._inputs:
                raise ValueError(
                    'Variable %s not found in StateCell!' % name)
            if len(var.shape) < 2:
                raise ValueError(
                    'input_var_dict entries must be [batch, ...]; '
                    '%s has shape %s' % (name, (var.shape,)))
            if idx is None:
                ones = layers.fill_constant_batch_size_like(
                    var, shape=[-1, 1], dtype='int64', value=1)
                bidx = layers.elementwise_sub(
                    layers.cumsum(ones, axis=0), ones)       # [B,1] 0..B-1
                lanes = layers.fill_constant_batch_size_like(
                    var, shape=[-1, k], dtype='int64', value=0)
                idx = layers.reshape(
                    layers.elementwise_add(lanes, bidx), shape=[-1])
            feed_dict[name] = layers.gather(var, idx)

        with self.block():
            prev_ids = self.read_array(init=self._cur_ids, is_ids=True)
            self.read_array(init=self._cur_scores, is_scores=True)
            prev_ids_embedding = layers.embedding(
                layers.reshape(prev_ids, shape=[-1, 1]),
                size=[self._target_dict_dim, self._word_dim],
                dtype='float32', is_sparse=self._sparse_emb,
                param_attr=self._emb_param_attr)
            prev_ids_embedding = layers.reshape(
                prev_ids_embedding, shape=[-1, self._word_dim])

            for input_name in self._state_cell._inputs:
                if input_name not in feed_dict:
                    feed_dict[input_name] = prev_ids_embedding

            self.state_cell.compute_state(inputs=feed_dict)
            current_state = self.state_cell.out_state()
            scores = layers.fc(current_state, size=self._target_dict_dim,
                               act='softmax',
                               param_attr=self._score_param_attr,
                               bias_attr=self._score_bias_attr)
            sel_ids, _ = self.search_step(layers.log(scores))
            self.state_cell.update_states()
            self.commit_states()

            # all-finished => stop: every selected id is end_id
            end_fill = layers.fill_constant_batch_size_like(
                input=sel_ids, shape=[-1, k], dtype='int64',
                value=float(self._end_id))
            alive = layers.reduce_sum(
                layers.cast(layers.logical_not(
                    layers.equal(sel_ids, end_fill)), 'float32'))
            half = layers.fill_constant(shape=[1], dtype='float32',
                                        value=0.5)
            any_alive = layers.less_than(half,
                                         layers.reshape(alive, shape=[1]))
            layers.assign(layers.logical_and(self._cond, any_alive),
                          output=self._cond)

    def __call__(self):
        """Backtrack the recorded ids/parents into full sequences.
        Returns (sentence_ids [B, K, max_len], sentence_scores [B, K])."""
        if self._status != BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER:
            raise ValueError('Output of BeamSearchDecoder object can only be '
                             'visited outside the block.')
        return layers.beam_search_decode(
            self._ids_array, self._parents_array, self._cur_scores,
            beam_size=self._beam_size, end_id=self._end_id)

    def _assert_in_decoder_block(self, method):
        if self._status != BeamSearchDecoder.IN_BEAM_SEARCH_DECODER:
            raise ValueError('%s should be invoked inside block of '
                             'BeamSearchDecoder object.' % method)

"""ZeRO stage 3's parameter gather and release, for eager PyTorch.

The JAX engine leaves stage 3's gather and release to XLA: the
compute-dtype parameters are data-sharded arrays and the compiler inserts
an all-gather before each use (``deepspeed_tpu/runtime/engine.py:1160-1172,
1272-1290``). Eager PyTorch has no compiler to do that, so the port
gathers by hand, one unit at a time (``FlatPartition``'s units: GPT-2's
embedding, each block, ``ln_f``), through :class:`Stage3`'s :meth:`call`:

* forward: the unit's pieces are all-gathered (one collective a unit),
  its parameters become views of the full buffer, the unit's function
  runs without autograd, and the parameters go back to an empty
  placeholder, so the full buffer frees at once. Only the call's inputs
  are kept for the backward (each block's input, as activation
  checkpointing keeps it);
* backward: the unit is gathered again, its function re-run under
  autograd on the saved inputs, and ``torch.autograd.grad`` gives the
  gradients of the inputs and of the unit's parameters. These are added
  into the unit's gradient buffer (as autograd adds into a ``.grad``),
  and when the call owns the unit, the buffer is reduce-scattered into
  the rank's accumulator piece before the next unit's backward begins.

The call is the unit's checkpoint: every unit's forward runs twice
whatever ``remat`` says, and nothing of it is saved between the passes,
so the three places where eager autograd would pin gathered weights
cannot: the fused LN + QKV + flash op saves ``ln_scale, ln_bias, qkv_w,
qkv_b`` for its backward only inside the recompute (freed with it), a
``torch.utils.checkpoint`` recompute is never needed (the model builds
its blocks with ``remat`` off under stage 3), and a tied weight used in
two calls (GPT-2's ``wte``: the embedding and the loss head) is gathered
by both: the head's call *borrows* the embedding unit, deposits its
contribution, and the embedding's own call, whose backward runs last,
adds the lookup's contribution and reduce-scatters the sum. Both
contributions reach the accumulator through one reduce-scatter of their
sum in the compute dtype, as autograd sums them into one ``.grad`` at
stage 2, so the stages agree bit for bit.

The persistent unit (leaves kept whole on every rank) is never gathered
here: its leaves view ``FlatPartition.persist`` between steps, its
gradients collect in ``persist_grads`` across calls and are folded once
a micro-step by the engine.

How a unit is gathered is the partition's ``gatherer``
(``runtime/zero/zeropp.py``): one all-gather, qwZ's int8 lanes and
scales, or the ring gather (``comm.collective_matmul.zero_gather``). The
ring overlaps as the JAX docstring puts it ("materialization for layer
k+1 can overlap layer k's compute"): each gather notes which gather
followed it last time (its units and its pass, forward or backward), and
posts that one's ring before its own function runs, so one more gathered
unit is alive at a time. A gather is known by its units, its pass and
how many gathers of the same units and pass came before it in the
forward call (GPT-2's head gathers the embedding unit again). The
following gather takes the posted ring if it asked for those units, and
otherwise finishes and drops it (every rank runs the
same sequence, so every rank posts the same collectives in the same
order); the backward before an apply step posts no ring for the next
forward, whose parameters the step changes.
"""
import torch


class _GatheredCall(torch.autograd.Function):
    """``fn(*inputs)`` with the call's units gathered; see the module
    docstring. ``anchor`` is a leaf that requires grad, so the backward
    runs even when no input does (the embedding's token ids)."""

    @staticmethod
    def forward(ctx, z3, fn, units, borrow, anchor, *inputs):
        ctx.z3, ctx.fn, ctx.units, ctx.borrow = z3, fn, units, borrow
        with z3.gathered(units + borrow, "forward"):
            out = fn(*inputs)
        ctx.save_for_backward(*inputs)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        z3 = ctx.z3
        needs = ctx.needs_input_grad[5:]
        inputs = [t.detach().requires_grad_(need and t.is_floating_point())
                  for t, need in zip(ctx.saved_tensors, needs)]
        with z3.gathered(ctx.units + ctx.borrow, "backward"):
            with torch.enable_grad():
                out = ctx.fn(*inputs)
            params = z3.params_of(ctx.units + ctx.borrow)
            wanted = [t for t in inputs if t.requires_grad]
            grads = torch.autograd.grad(out, wanted + params, grad_out,
                                        allow_unused=True)
        z3.deposit(ctx.units + ctx.borrow, grads[len(wanted):])
        z3.reduce(ctx.units)
        grads = iter(grads[:len(wanted)])
        return (None,) * 5 + tuple(next(grads) if t.requires_grad else None
                                   for t in inputs)


class Stage3:
    """The gather/release runtime over a stage-3 ``FlatPartition``.

    ``units`` is the model's ``[(unit name, [parameter names])]`` (the
    ``zero3_units`` of its module, or one unit of every parameter). A
    model that knows its units calls :meth:`call` around each (GPT-2's
    loss does when the engine sets ``module._zero3``); the engine wraps
    any other module's whole forward in one call."""

    def __init__(self, flat, units):
        self.flat = flat
        index = {name: i for i, name in enumerate(flat.names)}
        self.members = {uname: [index[n] for n in names]
                        for uname, names in units}
        self._anchor = torch.zeros((), requires_grad=True)
        self.gathers = 0        # unit all-gathers (forward and backward)
        # the ring's prefetch: gather key -> the key that followed it;
        # the gathers of each (units, pass) since the forward call began
        self._next, self._last, self._seen = {}, None, {}
        self._posted = None     # (key, {unit: pending gather})
        self.prefetched = 0     # gathers served by a posted ring
        # set by the engine for the backward before an apply step: no
        # ring is posted there for the next forward (the parameters
        # change first)
        self.last_backward = False

    def _leaf_indices(self, unames):
        seen, out = set(), []
        for uname in unames:
            for i in self.members[uname]:
                if i not in seen:
                    seen.add(i)
                    out.append(i)
        return out

    def _flat_units(self, unames):
        """The partition's units holding the named units' leaves (the
        persistent unit left out: it stays gathered)."""
        flat = self.flat
        units = {flat.unit_of[flat.names[i]]
                 for i in self._leaf_indices(unames)}
        units.discard(flat.persist_unit)
        return sorted(units)

    def params_of(self, unames):
        """The ``nn.Parameter`` leaves of the named units, in one fixed
        order (what :meth:`deposit` takes gradients in)."""
        return [self.flat._module_params[i]
                for i in self._leaf_indices(unames)]

    def gathered(self, unames, phase="forward"):
        return _Gathered(self, self._flat_units(unames), phase)

    def begin_pass(self):
        """A forward call begins (the engine's): the gathers' keys count
        from there."""
        self._seen = {}

    def _acquire(self, units, key):
        """The full buffers of ``units``: from the posted ring when it
        gathered them, else gathered now; then the ring of the gather that
        followed this one last time is posted."""
        flat = self.flat
        if not units:
            return []
        ring = flat.gatherer.ring is not None
        posted, self._posted = self._posted, None
        if ring:
            if self._last is not None:
                self._next[self._last] = key
            self._last = key
        pending = {}
        if posted is not None:
            if posted[0] == key:
                pending = posted[1]
                self.prefetched += len(units)
            else:
                for p in posted[1].values():
                    p.finish()
        full = [flat.gather_unit(u, pending.get(u)) for u in units]
        nxt = self._next.get(key) if ring else None
        if nxt is not None and not (self.last_backward and
                                    nxt[1] == "forward"):
            self._posted = (nxt, {u: flat.gatherer.start(u)
                                  for u in nxt[0]})
        return full

    def drop_posted(self):
        """Finish and drop a posted ring nothing took (before the
        partition's parameters change)."""
        posted, self._posted = self._posted, None
        if posted is not None:
            for p in posted[1].values():
                p.finish()

    def deposit(self, unames, grads):
        """Add one gradient per leaf of ``params_of(unames)`` (None where
        unused) into the partition units that hold them."""
        flat = self.flat
        by_leaf = dict(zip(self._leaf_indices(unames), grads))
        for u in sorted({flat.unit_of[flat.names[i]] for i in by_leaf}):
            _, _, _, leaves = flat.units[u]
            flat.deposit(u, [by_leaf.get(i) for i in leaves])

    def reduce(self, unames):
        """Reduce-scatter the units the named units own (their backward
        has ended: nothing adds to them later in this micro-step)."""
        for u in self._flat_units(unames):
            self.flat.reduce_unit(u)

    def call(self, fn, *inputs, units, borrow=()):
        """``fn(*inputs)`` (tensors in, one tensor out) with the
        parameters of ``units`` and ``borrow`` gathered; the gradients of
        ``units`` are reduce-scattered when its backward ends, those of
        ``borrow`` only added (their owner's call reduces them)."""
        return _GatheredCall.apply(self, fn, tuple(units), tuple(borrow),
                                   self._anchor, *inputs)

    def full_state(self):
        """``{name: compute-dtype tensor}`` of every parameter, whole
        (every rank of the data group must call)."""
        return self.flat.tree_of(self.flat.params, keep_dtype=True)


class _Gathered:
    """Context: the partition units gathered on entry, released on
    exit."""

    def __init__(self, z3, units, phase):
        self.z3, self.units, self.phase = z3, units, phase

    def __enter__(self):
        z3, key = self.z3, (tuple(self.units), self.phase)
        seen = z3._seen.get(key, 0)
        z3._seen[key] = seen + 1
        self._full = z3._acquire(self.units, key + (seen,))
        self.z3.gathers += len(self.units)
        return self

    def __exit__(self, *exc):
        for u in self.units:
            self.z3.flat.release_unit(u)
        self._full = None
        return False

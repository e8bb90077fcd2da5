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
"""
import torch


class _GatheredCall(torch.autograd.Function):
    """``fn(*inputs)`` with the call's units gathered; see the module
    docstring. ``anchor`` is a leaf that requires grad, so the backward
    runs even when no input does (the embedding's token ids)."""

    @staticmethod
    def forward(ctx, z3, fn, units, borrow, anchor, *inputs):
        ctx.z3, ctx.fn, ctx.units, ctx.borrow = z3, fn, units, borrow
        with z3.gathered(units + borrow):
            out = fn(*inputs)
        ctx.save_for_backward(*inputs)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        z3 = ctx.z3
        needs = ctx.needs_input_grad[5:]
        inputs = [t.detach().requires_grad_(need and t.is_floating_point())
                  for t, need in zip(ctx.saved_tensors, needs)]
        with z3.gathered(ctx.units + ctx.borrow):
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

    def gathered(self, unames):
        return _Gathered(self, self._flat_units(unames))

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

    def __init__(self, z3, units):
        self.z3, self.units = z3, units

    def __enter__(self):
        self._full = [self.z3.flat.gather_unit(u) for u in self.units]
        self.z3.gathers += len(self.units)
        return self

    def __exit__(self, *exc):
        for u in self.units:
            self.z3.flat.release_unit(u)
        self._full = None
        return False

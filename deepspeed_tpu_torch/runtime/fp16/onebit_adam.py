"""1-bit Adam: Adam whose momentum crosses the wire as sign bits, with
error feedback.

Port of ``deepspeed_tpu/runtime/fp16/onebit_adam.py::OnebitAdam`` (the
reference's ``onebit/adam.py``). Two regimes, chosen by the engine from
its attempted-step count (:meth:`OnebitAdam.frozen_at`):

* warmup (step < ``freeze_step``): exact Adam (L2 weight decay) on the
  gradient averaged over the data group, through the fp32 all-reduce or
  the in-collective int8 ring (``comm.quantized_collectives``);
* frozen (step >= ``freeze_step``): the variance is frozen; each worker
  updates the momentum from its own local gradient and the momentum
  crosses the wire through ``runtime/comm/onebit.py``'s worker and server
  phases (sign bytes and one scale each), with fp32 worker and server
  error feedback.

The state, lane for lane the JAX engine's: ``exp_avg`` one fused flat
fp32 buffer in the JAX package's leaf order (``FusedFlatLayout``, padded
to ``onebit_padded_size``), the same on every rank; ``exp_avg_sq`` in the
engine's flat partition (leaf-shaped in the JAX tree); ``worker_error``
this rank's ``(padded,)`` row and ``server_error`` its ``(padded /
world,)`` row. The update is plain PyTorch math, not the fused Adam
kernel, as in the JAX package (``use_pallas=False``).

Rejected as in the JAX package: ``cuda_aware: true`` (the exchange runs
over ``torch.distributed``; no CUDA-aware MPI path is ported);
``max_coeff`` / ``min_coeff`` warn and are ignored; ``comm_backend_name``
warns unless it names the data group's own backend.
"""
import functools

import numpy as np
import torch

from ...ops.adam.fused_adam import FusedAdam, bias_corrections, f32
from ...utils.logging import logger
from ..comm.onebit import onebit_all_gather_local, \
    onebit_reduce_scatter_local, onebit_padded_size
from ..comm.quantize import FusedFlatLayout


class OnebitAdam(FusedAdam):
    name = "onebitadam"
    supports_zero = True
    # the engine zeroes these on an overflowed step: the window compressed
    # inf/nan and the residuals are poisoned
    error_state_keys = ("worker_error", "server_error")

    def __init__(self, lr=1e-3, freeze_step=100000, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 max_coeff=None, min_coeff=None, amsgrad=False,
                 cuda_aware=False, comm_backend_name=None, **kwargs):
        kwargs.pop("use_kernel", None)
        if kwargs:
            logger.warning("OneBitAdam ignores the optimizer params %s",
                           sorted(kwargs))
        super().__init__(lr=lr, bias_correction=bias_correction, betas=betas,
                         eps=eps, adam_w_mode=False,
                         weight_decay=weight_decay, amsgrad=amsgrad,
                         use_kernel=False)
        if cuda_aware:
            raise ValueError(
                "OneBitAdam cuda_aware=true names a CUDA-aware MPI transport "
                "this runtime does not have: the compressed exchange runs "
                "over torch.distributed (all_to_all and all_gather); remove "
                "the key")
        if max_coeff is not None or min_coeff is not None:
            logger.warning(
                "OneBitAdam max_coeff/min_coeff are 1-bit LAMB coefficient "
                "bounds; OneBitAdam ignores them (reference parity)")
        self.freeze_step = int(freeze_step)
        self.comm_backend_name = comm_backend_name
        self.group = None
        self.world_size = 1
        self.rank = 0
        self._layout = None
        self.exp_avg = self.worker_error = self.server_error = None
        self._reshard_pristine = None

    # ------------------------------------------------------------ comm setup
    def configure_comm(self, group):
        """Bind the exchange to the data ``group`` (None at one rank)."""
        import torch.distributed as dist
        self.group = group
        self.world_size = dist.get_world_size(group) if group is not None \
            else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        name = self.comm_backend_name
        backend = dist.get_backend(group) if group is not None else None
        if name is not None and str(name).lower() != backend:
            logger.warning(
                "OneBitAdam comm_backend_name=%r reinterpreted: the "
                "compressed allreduce runs over the data group's "
                "torch.distributed backend (%s)", name, backend)

    def frozen_at(self, step):
        """Whether attempted step ``step`` (0-based, the engine's
        ``global_steps``) runs the compressed regime."""
        return int(step) >= self.freeze_step

    # ---------------------------------------------------------------- state
    def init_flat_state(self, leaves, device):
        """The fused layout over ``leaves`` (``(name, shape)`` in the JAX
        flatten order) and zero state on ``device``."""
        w = self.world_size
        self._layout = FusedFlatLayout(
            leaves, lambda n: onebit_padded_size(n, w))
        padded = self._layout.padded
        self.exp_avg = torch.zeros(padded, dtype=torch.float32,
                                   device=device)
        self.worker_error = torch.zeros_like(self.exp_avg)
        self.server_error = torch.zeros(padded // w, dtype=torch.float32,
                                        device=device)
        return self._layout

    @property
    def layout(self):
        return self._layout

    def reset_error_state(self):
        self.worker_error.zero_()
        self.server_error.zero_()

    def reshard_state(self, opt, saved_world, pristine=None):
        """A gathered optimizer state saved at ``saved_world`` workers
        (numpy; ``{"_flat": ...}`` fused buffers) canonicalised to this
        optimizer's world, as the JAX package's ``reshard_state``: the
        momentum and the server residual truncated to the real lanes and
        re-padded (bitwise); the worker residuals restored from the
        ``onebit_pristine`` sidecar when it was saved at this world,
        otherwise summed in index order into row 0 (the sidecar of the
        original rows kept on ``_reshard_pristine``). A same-world call, or
        a state without the fused buffers, returns ``opt`` unchanged."""
        if self._layout is None:
            raise RuntimeError(
                "OnebitAdam.reshard_state before init_flat_state (the "
                "flat-buffer layout supplies numel/padding)")
        w_new = self.world_size
        self._reshard_pristine = pristine
        if int(saved_world) == w_new:
            return opt
        fused = ("exp_avg", "worker_error", "server_error")
        if not all(isinstance(opt.get(k), dict) and "_flat" in opt[k]
                   for k in fused):
            return opt
        numel, padded_new = self._layout.numel, self._layout.padded

        def repad(flat):
            flat = np.asarray(flat, np.float32).reshape(-1)[:numel]
            out = np.zeros(padded_new, np.float32)
            out[:numel] = flat
            return out

        out = dict(opt)
        out["exp_avg"] = {"_flat": repad(opt["exp_avg"]["_flat"])}
        out["server_error"] = {"_flat": repad(
            opt["server_error"]["_flat"]).reshape(w_new,
                                                  padded_new // w_new)}
        if pristine is not None and int(pristine.get("world", -1)) == w_new:
            rows = np.asarray(pristine["rows"], np.float32)
            we = np.zeros((w_new, padded_new), np.float32)
            we[:, :numel] = rows[:, :numel]
            out["worker_error"] = {"_flat": we}
            logger.info(
                "OneBitAdam: resharded error-feedback state %d -> %d "
                "workers (pristine %d-way worker residuals restored "
                "bit-exactly)", int(saved_world), w_new, w_new)
        else:
            rows = [np.asarray(r, np.float32)
                    for r in opt["worker_error"]["_flat"]]
            total = functools.reduce(np.add, rows)
            we = np.zeros((w_new, padded_new), np.float32)
            we[0] = repad(total)
            out["worker_error"] = {"_flat": we}
            if pristine is None:
                self._reshard_pristine = {
                    "world": int(saved_world),
                    "rows": np.stack([r[:numel] for r in rows]),
                }
            logger.info(
                "OneBitAdam: resharded error-feedback state %d -> %d "
                "workers (momentum/server residual bitwise; worker "
                "residuals folded to their sum, original rows kept as the "
                "pristine sidecar)", int(saved_world), w_new)
        return out

    # ------------------------------------------------------------- update
    def exchange(self, g_fused, wd_fused=None):
        """The frozen regime's momentum exchange: this rank's momentum
        ``beta1 * m + (1 - beta1) * g`` (``g`` its local fused gradient,
        plus ``wd_fused`` when given), compressed through the worker and
        server phases; ``exp_avg``, ``worker_error`` and ``server_error``
        replaced by the results (the momentum the same on every rank)."""
        layout = self._layout
        beta1 = f32(self.betas[0])
        one_minus = f32(np.float32(1.0) - np.float32(beta1))
        g = g_fused if wd_fused is None else g_fused + wd_fused
        m_w = beta1 * self.exp_avg + one_minus * g
        chunk_mean, cmask, ccount, nwe = onebit_reduce_scatter_local(
            m_w, self.worker_error, self.group, real_size=layout.numel)
        full, nse = onebit_all_gather_local(
            chunk_mean, self.server_error, self.group, cmask, ccount)
        mask = (torch.arange(layout.padded, device=full.device) <
                layout.numel).to(torch.float32)
        self.exp_avg = full * mask
        self.worker_error = nwe
        self.server_error = nse

    def warmup_momentum(self, g_fused):
        """The warmup regime's momentum: ``beta1 * m + (1 - beta1) * g`` of
        the averaged fused gradient."""
        beta1 = f32(self.betas[0])
        one_minus = f32(np.float32(1.0) - np.float32(beta1))
        self.exp_avg = beta1 * self.exp_avg + one_minus * g_fused

    def warmup_variance(self, v, g):
        """``v <- beta2 * v + (1 - beta2) * g * g`` in place (fp32)."""
        beta2 = f32(self.betas[1])
        one_minus = f32(np.float32(1.0) - np.float32(beta2))
        v.copy_(beta2 * v + one_minus * (g * g))

    def apply_update(self, p, m, v, step):
        """``p <- p - lr * ((m / bc1) / (sqrt(v / bc2) + eps))`` in place
        over one range of the master (fp32), at optimizer step ``step``
        (the count after this update); true divisions."""
        h = {k: f32(val) for k, val in self.hyperparams().items()}
        bc1, bc2 = bias_corrections(h["beta1"], h["beta2"], step,
                                    self.bias_correction)
        bc1, bc2 = (torch.tensor(bc, dtype=torch.float32, device=p.device)
                    for bc in (bc1, bc2))
        update = (m / bc1) / (torch.sqrt(v / bc2) + h["eps"])
        p.copy_(p - h["lr"] * update)

    def step_flat(self, *args, **kwargs):
        raise RuntimeError(
            "OnebitAdam steps through the engine's 1-bit apply step (its "
            "momentum lives in the fused layout), not step_flat")

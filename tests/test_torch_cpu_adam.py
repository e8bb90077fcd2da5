"""The host Adam op (``ops/adam/cpu_adam.py`` over ``csrc/cpu_adam.cpp``)
against its plain PyTorch version and against the JAX package's
``adam_step_host`` on the same inputs.

Inputs are drawn from a seed with numpy: 50,000 elements (p, g ~ N(0, 1),
m ~ 0.1 N(0, 1), v ~ 0.01 |N(0, 1)|) at step 3 (bias corrections
1 - beta ** 3), in both ``adam_w_mode`` values, with and without weight
decay. Tolerance: p, m and v within :data:`ULPS` units in the last place
of fp32 at the scale of the operation that made them (p: the larger of
the old and new |p|; m: of |m| and |g|; v: of |v| and g^2 (1 - beta2)),
as a contracted FMA differs from two roundings by at most a rounding of
the product: a value near a cancellation (a new p or m near 0) has few
bits of its own. The port builds the source
without ``-march=native``, the JAX package's builder with it, so one
compiler may contract ``a * b + c`` into an FMA where the other does
not; on a host whose baseline has no FMA the op equals its plain version
bit for bit. Splitting the buffer across threads changes no bit.
The fused variant's bf16 copy equals ``Tensor.to(torch.bfloat16)``
wherever the value is not NaN, and a NaN stays NaN. A compiler that
cannot be found, and a source that does not compile, raise
``HostBuildError``.
"""
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.cpu_adam_native import adam_step_host
from deepspeed_tpu_torch.ops import host_build
from deepspeed_tpu_torch.ops.adam import cpu_adam as ca

pytestmark = pytest.mark.torch_port

N = 50_000
ULPS = 4
BETA1, BETA2, STEP = 0.9, 0.999, 3


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    p = rng.randn(N).astype(np.float32)
    g = rng.randn(N).astype(np.float32)
    m = (rng.randn(N) * 0.1).astype(np.float32)
    v = (np.abs(rng.randn(N)) * 0.01).astype(np.float32)
    return p, g, m, v


def _hyper(adam_w, wd):
    return dict(lr=1e-3, beta1=BETA1, beta2=BETA2, eps=1e-8,
                weight_decay=wd, bc1=1 - BETA1 ** STEP,
                bc2=1 - BETA2 ** STEP, adam_w_mode=adam_w)


def _close(got, want, *scales):
    """|got - want| within ULPS fp32 spacings of the largest scale."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.max(np.abs(np.stack([np.asarray(s, np.float32)
                                    for s in (got,) + scales])), axis=0)
    return bool(np.all(np.abs(got.astype(np.float64) - want) <=
                       ULPS * np.spacing(scale).astype(np.float64)))


@pytest.mark.parametrize("adam_w", [True, False])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_op_matches_plain_and_jax(adam_w, wd):
    h = _hyper(adam_w, wd)
    arrays = _inputs()
    op = [torch.from_numpy(a.copy()) for a in arrays]
    split = [torch.from_numpy(a.copy()) for a in arrays]
    plain = [torch.from_numpy(a.copy()) for a in arrays]
    ca.cpu_adam(*op, threads=1, **h)
    ca.cpu_adam(*split, threads=3, **h)
    ca.cpu_adam_reference(*plain, **h)
    jp, jm, jv = adam_step_host(*arrays, h["lr"], BETA1, BETA2, h["eps"],
                                wd, h["bc1"], h["bc2"], int(adam_w))
    p, g, m, v = arrays
    g_eff = g if adam_w else g + np.float32(wd) * p
    scales = {0: (p,), 2: (m, g_eff), 3: (v, g_eff * g_eff * (1 - BETA2))}
    for i, want in zip((0, 2, 3), (jp, jm, jv)):
        assert torch.equal(op[i], split[i])
        assert _close(op[i], plain[i], *scales[i])
        assert _close(op[i], want, *scales[i])
    # the step moved the parameters
    assert not torch.equal(op[0], torch.from_numpy(arrays[0]))


def test_bf16_copy_matches_torch_and_keeps_nan():
    p, g, m, v = (torch.from_numpy(a) for a in _inputs(1))
    p[:2] = torch.tensor([float("nan"), -float("nan")])
    half = torch.empty(N, dtype=torch.bfloat16)
    plain_half = torch.empty(N, dtype=torch.bfloat16)
    plain = [t.clone() for t in (p, g, m, v)]
    h = _hyper(True, 0.0)
    ca.cpu_adam(p, g, m, v, p_bf16=half, **h)
    ca.cpu_adam_reference(*plain, p_bf16=plain_half, **h)
    want = p.to(torch.bfloat16)
    finite = ~torch.isnan(p)
    assert torch.equal(half[finite], want[finite])
    assert torch.isnan(half[:2]).all() and torch.isnan(p[:2]).all()
    # the plain version rounds as the C++ does, NaN bits included
    assert torch.equal(half.view(torch.int16), plain_half.view(torch.int16))


def test_missing_compiler_and_bad_source_raise(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "no-such-compiler-for-the-host-op")
    with pytest.raises(host_build.HostBuildError, match="not found"):
        ca.build()
    monkeypatch.delenv("CXX")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(host_build.HostBuildError):
        host_build.build(bad)


def test_wrong_buffers_raise():
    p, g, m, v = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="fp32 CPU"):
        ca.cpu_adam(p.double(), g, m, v, **_hyper(True, 0.0))
    with pytest.raises(ValueError, match="fp32 CPU"):
        ca.cpu_adam(p, g[::2].contiguous(), m, v, **_hyper(True, 0.0))

"""The fp32 key-mask case of ``chip_smoke.py``'s ``flash_fp32_repeats``
(b 2, s 96, h 2, d 32, 25% of keys masked by -1e9) on the CPU, where the
plain versions run: the side that, on the chip's host, now and then
returned a run ~2e-5 off float64 (ROADMAP Queue 3 item 2).

Pinned here: the CPU plain forward and backward give the same bits over
repeated runs, at 1 to 8 intra-op threads, from input buffers at any
alignment and with denormals flushed; and each of the forward's
intermediates per key tile (S over the unmasked keys, P, the row sums l,
P.V, from ``flash_fwd_reference``'s ``trace``) stays within twice what
was measured against a float64 evaluation of the same online softmax
(S 8.7e-7, P 7.6e-7, l 8.5e-6, P.V 5.0e-6, out 3.7e-7 on this CPU and on
the chip's host), which a run at reduced precision would leave.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
BOUNDS = {"S": 2e-6, "P": 2e-6, "l": 2e-5, "PV": 1e-5}


def _moved(array, offset):
    """``array``'s values in a buffer that starts ``offset`` floats past
    an allocation."""
    buf = np.empty(array.size + 32, np.float32)
    view = buf[offset:offset + array.size].reshape(array.shape)
    view[...] = array
    return view


@pytest.fixture(scope="module")
def case():
    arrays, mask = cs.flash_fp32_case()
    return arrays, mask, cs.flash_fp32_run(arrays, mask, CPU)


@pytest.mark.parametrize("condition", ["threads1", "threads2", "threads8",
                                       "offset1", "offset3", "ftz"])
def test_cpu_plain_case_is_bit_stable(case, condition):
    arrays, mask, want = case
    threads, ftz = torch.get_num_threads(), False
    try:
        if condition.startswith("threads"):
            torch.set_num_threads(int(condition[7:]))
        elif condition.startswith("offset"):
            off = int(condition[6:])
            arrays = [_moved(a, off) for a in arrays]
            mask = _moved(mask, off)
        else:
            ftz = torch.set_flush_denormal(True)
        got = cs.flash_fp32_run(arrays, mask, CPU)
    finally:
        torch.set_num_threads(threads)
        if ftz:
            torch.set_flush_denormal(False)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert torch.equal(a, b), (condition, name,
                                   float((a - b).abs().max()))


def test_cpu_plain_intermediates_against_float64(case):
    arrays, mask, want = case
    traces = [[] for _ in range(3)]
    runs = [cs.flash_fp32_run(arrays, mask, CPU, trace=t) for t in traces]
    exact = cs._online_float64(arrays, mask)
    assert len(traces[0]) == len(exact) == 2          # 96 keys, tiles of 64
    report = cs._trace_report(traces, exact)
    for run, rep in zip(runs, report):
        assert all(torch.equal(a, b) for a, b in zip(run, want))
        assert rep["first_differing_from_run_1"] is None
        for op, bound in BOUNDS.items():
            assert rep["max_abs_err_vs_float64"][op] <= bound, (op, rep)
    out64 = np.transpose(exact[-1]["PV"] / exact[-1]["l"], (0, 2, 1, 3))
    assert float(np.abs(want[0].double().numpy() - out64).max()) <= 1e-6

"""The port's copy of the host-side paging logic against the original.

``deepspeed_tpu_torch/inference/paging.py`` is a verbatim copy of
``deepspeed_tpu/inference/paging.py`` (the port imports nothing of the
JAX package). A seeded random sequence of alloc / free / ref / fork /
register / match / unmatch / evict / clear drives one allocator + prefix
cache from each module in lockstep; every return value, exception and
the full state must agree after every operation. ``plan_chunks`` is held
to the original over a grid of its inputs.
"""
import numpy as np
import pytest

from deepspeed_tpu.inference import paging as jax_paging
from deepspeed_tpu_torch.inference import paging as port_paging

pytestmark = pytest.mark.torch_port

PAGE = 4


class _Pool:
    """One module's allocator + prefix cache and the pages a caller
    holds, driven by :func:`_apply`."""

    def __init__(self, mod, num_pages, max_entries):
        self.mod = mod
        self.alloc = mod.PageAllocator(num_pages)
        self.cache = mod.PrefixCache(self.alloc, PAGE,
                                     max_entries=max_entries)
        self.held = []

    def state(self):
        return (self.alloc.free_pages, self.alloc.pages_in_use,
                list(self.alloc._refs), list(self.alloc._free),
                list(self.cache._entries.items()), self.cache.stats(),
                list(self.held))


def _apply(pool, op, arg):
    """Run one operation; -> its result or the exception's type name."""
    a, c = pool.alloc, pool.cache
    try:
        if op == "alloc":
            page = a.alloc()
            pool.held.append(page)
            return page
        if op == "free":
            return a.free(pool.held.pop(arg % len(pool.held))) \
                if pool.held else None
        if op == "ref":
            if not pool.held:
                return None
            page = pool.held[arg % len(pool.held)]
            a.ref(page)
            pool.held.append(page)
            return page
        if op == "fork":
            if not pool.held:
                return None
            i = arg % len(pool.held)
            new, forked = a.fork(pool.held[i])
            pool.held[i] = new
            return new, forked
        tokens = arg
        if op == "register":
            pages = [a.alloc() for _ in range(len(tokens) // PAGE)]
            c.register(tokens, pages)
            pool.held += pages
            return pages
        if op == "match":
            pages, n = c.match(tokens, len(tokens) - 1)
            pool.held += pages
            return pages, n
        if op == "match_unmatch":
            pages, _ = c.match(tokens, len(tokens))
            c.unmatch(pages)
            return pages
        if op == "evict":
            return c.evict(len(tokens))
        if op == "clear":
            return c.clear()
        raise AssertionError(op)
    except Exception as err:  # noqa: BLE001 - the exception IS the result
        return type(err).__name__


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paging_copy_matches_original_over_random_ops(seed):
    rng = np.random.RandomState(seed)
    pools = [_Pool(mod, num_pages=24, max_entries=10)
             for mod in (jax_paging, port_paging)]
    prefixes = [rng.randint(0, 6, size=3 * PAGE).tolist() for _ in range(3)]
    ops = ["alloc", "free", "ref", "fork", "register", "match",
           "match_unmatch", "evict", "clear"]
    weights = np.array([6, 5, 2, 2, 3, 4, 1, 1, 0.3])
    for step in range(400):
        op = ops[rng.choice(len(ops), p=weights / weights.sum())]
        if op in ("register", "match", "match_unmatch", "evict"):
            base = prefixes[rng.randint(len(prefixes))]
            arg = base[:rng.randint(0, len(base) + 1)] + \
                rng.randint(0, 6, size=rng.randint(0, 2 * PAGE)).tolist()
        else:
            arg = int(rng.randint(1 << 20))
        results = [_apply(p, op, arg) for p in pools]
        assert results[0] == results[1], (step, op, results)
        assert pools[0].state() == pools[1].state(), (step, op)
    assert pools[1].cache.hits > 0 and pools[1].alloc.pages_in_use > 0


def test_plan_chunks_copy_matches_original():
    buckets = (8, 16, 32)
    bucket_for = lambda n: min(b for b in buckets if b >= n)
    for n in range(1, 33):
        for chunk in (None, 3, 8, 16, 40):
            for max_seq in (33, 40, 64):
                for start in (0, 5):
                    for max_chunk in (None, 32):
                        args = (n, chunk, bucket_for, max_seq)
                        kw = dict(start=start, max_chunk=max_chunk)
                        assert port_paging.plan_chunks(*args, **kw) == \
                            jax_paging.plan_chunks(*args, **kw)


def test_paging_source_is_a_verbatim_copy():
    # the copy adds only its four-line provenance note to the docstring
    import inspect
    original = inspect.getsource(jax_paging).splitlines()
    copy = inspect.getsource(port_paging).splitlines()
    assert copy[2].startswith("(A verbatim copy")
    assert copy[:2] + copy[6:] == original

"""A guard against the kernel's limit on memory mappings a process, for
every test process of the suite.

Each program XLA compiles for the CPU holds about 19 memory mappings
until JAX's caches drop it, and a process may hold 65,530 by default
(`vm.max_map_count`); past that, XLA's next compile crashes the process,
and xdist loses the worker with every test it had left.  A worker of the
whole suite gathers programs from every module it runs: one property
test of the reference's sparse sampler leaves about 25,000 mappings by
itself, the port's parity tests a few thousand a module.  So after each
test, a process that holds more than `LIMIT` mappings drops JAX's
compiled programs (`jax.clear_caches()`), and the tests after it compile
what they need again.  No test's inputs, checks or tolerances change.

The module registers itself as a pytest plugin (`pytest_plugins`) when it
is collected, which every test process does before it runs a test.
"""
import gc

import jax
import jax.numpy as jnp

pytest_plugins = [__name__]

# mappings above which a process drops JAX's compiled programs after a
# test: under the limit by more than the most one test was seen to add
# (about 25,600)
LIMIT = 30_000


def process_mappings() -> int:
    """The memory mappings this process holds (0 without /proc)."""
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def pytest_runtest_teardown(item, nextitem):
    if process_mappings() > LIMIT:
        jax.clear_caches()


def test_dropping_compiled_programs_frees_their_mappings():
    if process_mappings() == 0:
        return                             # no /proc: nothing to count
    f = jax.jit(lambda x: jnp.cumsum(x * 2.0) + 1.0)
    for n in range(1, 61):
        f(jnp.ones(n)).block_until_ready()
    before = process_mappings()
    jax.clear_caches()
    gc.collect()
    assert process_mappings() < before - 500    # 60 programs dropped


def test_guard_drops_programs_only_past_the_limit(monkeypatch):
    import sys
    guard = sys.modules[__name__]
    calls = []
    monkeypatch.setattr(jax, "clear_caches", lambda: calls.append(1))
    for count, want in [(0, 0), (LIMIT, 0), (LIMIT + 1, 1)]:
        monkeypatch.setattr(guard, "process_mappings", lambda c=count: c)
        guard.pytest_runtest_teardown(None, None)
        assert len(calls) == want

"""Shared pytest config.

- registers the ``slow`` marker (multi-device subprocess tests);
- installs a minimal deterministic stand-in for ``hypothesis`` when the real
  package is not installed (the container has no network access, and the
  property tests only use ``@settings``/``@given``/``st.integers``). The
  stand-in replays each property test over a fixed-seed sample of the
  strategy space, always including the endpoints — weaker than real
  shrinking/search, but the properties still get exercised.
"""

import random
import sys
import types


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess tests (several minutes)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where there is none")


try:  # pragma: no cover - exercised only when hypothesis exists
    import hypothesis  # noqa: F401
except ImportError:
    class _Integers:
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def example(self, rng):
            return rng.randint(self.lo, self.hi)

        def endpoints(self):
            return [self.lo, self.hi]

    def _given(*strategies):
        def deco(fn):
            def wrapper():
                rng = random.Random(fn.__qualname__)
                n = getattr(wrapper, "_max_examples", 10)
                cases = [[s.endpoints()[0] for s in strategies],
                         [s.endpoints()[1] for s in strategies]]
                while len(cases) < n:
                    cases.append([s.example(rng) for s in strategies])
                for args in cases[:n]:
                    fn(*args)

            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            wrapper._max_examples = 10
            return wrapper

        return deco

    def _settings(max_examples=10, **_ignored):
        def deco(fn):
            fn._max_examples = max_examples
            return fn

        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = lambda lo, hi: _Integers(lo, hi)

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.__stub__ = True

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st

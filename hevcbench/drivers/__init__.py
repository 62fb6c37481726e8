"""Ways of driving the program's entry points, one module each, found by the
name a mix file gives under "driver".  Each module has a ``Driver`` class:
``Driver(ctx)``, ``setup()``, ``step(spans) -> CTUs coded``, ``release()``
and ``check(reference) -> compare.Checks``."""

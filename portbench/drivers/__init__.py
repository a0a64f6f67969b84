"""Traffic drivers: one module a kind of work, named by a mix's ``driver``.

Each module has ``make(config, mix, seed, device)``, returning an object
with ``setup()``, ``unit(i)`` (one unit of work through the program, its
record), ``end_to_end(window_s, records)``, ``release()``,
``check(records)`` (the numbers compared with the plain reference, and the
reference's outputs by event set) and ``counts(records, refs)`` (each hand
kernel's operations and bytes over the records' units).
"""

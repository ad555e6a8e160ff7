"""Drivers: one per kind of traffic, named by a traffic file's ``driver``.

Each ``run(run: harness.Run) -> harness.Outcome`` sets the program up from
the seed, warms up every shape the window uses, measures for
``run.seconds`` and compares what the window produced with the plain
reference.
"""

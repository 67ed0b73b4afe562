"""General drivers: each reads the parameters of a traffic file and drives the program.

A driver's ``run(ctx) -> harness.Outcome`` makes its inputs from the seed,
warms up every shape the traffic uses, runs the window, and judges what
the window's path produced against the configuration's plain reference.
"""

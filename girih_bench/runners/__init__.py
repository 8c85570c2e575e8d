"""The general runners a traffic file names under ``"runner"``.

Each module holds a `Runner` built from a `harness.Cell`: its constructor
is the set-up (inputs drawn from the seed, every shape warmed up),
``window(seconds)`` the measured window, returning the window's record
(answers the check will judge are kept, all else dropped as it comes),
and ``check()`` returns the numbers compared with the plain reference.
``problems(cell)`` draws the inputs a run judges, for the control.
"""

"""The program's side of entry points that a configuration names under
"entries": ``<name>.py`` here, with ``reference/<name>.py`` beside it, found
by ``lookup``.  Each public top-level function takes the ``Program`` (its
``at(qp)`` configuration, its ``tiers``) and a driver's inputs, calls the
port, and is bound to the ``Program`` under its own name; the reference's
side has the same function names and output keys."""

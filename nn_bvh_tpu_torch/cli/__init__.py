"""cli/ of the torch port: the learner's command lines (see the package
docstring)."""

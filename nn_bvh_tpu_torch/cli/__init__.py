"""cli/ of the torch port: render, train, tree_bench, imgtool, pspec and
format (see the package docstring)."""

"""utils/ of the torch port (see the package docstring)."""

"""learn/ of the torch port: the treeNet split learner and the joint
render+train step (see the package docstring)."""

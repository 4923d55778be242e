"""Hand-written Hopper kernels of the port, one folder per kernel family."""

#: what a gradient through a forward-only kernel wrapper raises with
NO_BACKWARD = ("{} has no backward kernel (nor has the reference's Pallas "
               "kernel); training takes the plain math: build the model "
               "with use_kernel=False")

"""Hand-written Hopper kernels (``csrc/*.cu``, built by ``_build`` at first
use): the four of the BIC pipeline and the flash-attention forward of the LM
stack (``attention``), each beside its plain-torch version and a launch
counter (``<wrapper>.launches``); ``ops`` holds the shape-tolerant entry
points and ``ref`` the oracles."""

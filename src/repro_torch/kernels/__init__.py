"""Hand-written Hopper kernels of the BIC pipeline (``csrc/*.cu``, built by
``_build`` at first use), each beside its plain-torch version and a launch
counter (``<wrapper>.launches``); ``ops`` holds the shape-tolerant entry
points and ``ref`` the oracles."""

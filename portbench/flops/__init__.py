"""The yardstick's arithmetic, frozen: operations and bytes per call of a
kernel and per token or sample of a model, computed from shapes, and the
card's peaks (``peaks.json``). The kernels may change; these do not."""

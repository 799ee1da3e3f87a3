"""Möller–Trumbore constants shared by the wavefront and the kernels
(src/objects/primatives/triangle.h:41-74)."""

MT_EPSILON = 1e-8  # triangle.h:43
T_MIN = 1e-3  # interval(0.001, infinity) used by all scatter rays

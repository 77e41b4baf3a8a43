"""GGNN propagation ops and the hand-written kernels that run them."""

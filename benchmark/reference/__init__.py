"""The benchmark's plain reference: a frozen copy of the port's torch-op
paths (commit d6443de) with the saliency math written as plain torch ops and
no CUDA kernel, no host library and no import of the port. The benchmark
runs it after each measured window and compares the port's outputs with
it."""

"""PyTorch/CUDA port of the xlstm_yolo detection framework.

The package mirrors the JAX package's module paths; importing it pulls in
nothing heavier than torch, numpy and yaml. Entry points run on the GPU
(``device="cuda"``) unless the caller asks for the CPU.
"""

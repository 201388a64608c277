"""The port's parallel stack: process groups over a (dp, tp, sp, pp, ep)
mesh (``mesh``), the torchrun bootstrap and the collectives the model code
calls (``distributed``), GPipe over stacked stages (``pipeline``) and the
mixture-of-experts FFN with expert parallelism (``moe``).

Port of ``xlstm_yolo_tpu/parallel/``. The JAX package runs one process that
jits over a device mesh; here every rank is a process (``torchrun
--nproc_per_node N``), and the mesh's axes are ``torch.distributed``
process groups: NCCL on the card, gloo on the CPU.
"""

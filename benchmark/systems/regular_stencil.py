"""The regular grid: ``H = -T + V`` as the program's matrix-free stencil
operator (the CUDA stencil SpMV and SpMM kernels), built on the card."""

import torch


def kernels(lt, device):
    """Load (on the first run of a checkout: build) the stencil kernels."""
    if torch.device(device).type == "cuda":
        from lanczos_tpu_torch.ops._build import load_stencil_library

        load_stencil_library()


def build(lt, config, device):
    return lt.build_regular_hamiltonian(
        config["n"], config["length"], lt.deuteron_potential_3d, stencil=config["stencil"],
        dtype=getattr(torch, config["dtype"]), device=device)

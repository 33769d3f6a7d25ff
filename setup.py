from setuptools import find_packages, setup

setup(
    name="relgat-projector-tpu",
    version="0.1.0",
    description=(
        "TPU-native relational-GNN framework: frozen-embedding RelGAT with "
        "projection head for knowledge-graph triplets (JAX/XLA/Pallas/pjit)"
    ),
    packages=find_packages(exclude=("tests*",)),
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "optax",
        "flax",  # serialization only
    ],
    extras_require={"wandb": ["wandb"], "torch": ["torch"]},
    entry_points={
        "console_scripts": [
            # Parity with reference setup.py:50-54.
            "relgat-projector-train=relgat_projector_tpu.cli:main",
            "relgat-projector-export=relgat_projector_tpu.export:main",
            "relgat-projector-import-torch=relgat_projector_tpu.interop:main",
            "relgat-projector-export-torch="
            "relgat_projector_tpu.interop:main_export",
            # The PyTorch/CUDA port's trainer (same flags, plus --device).
            "relgat-projector-train-torch="
            "relgat_projector_tpu_torch.cli:main",
            # The port's serving side: its export / inference CLI and its
            # reference-format import and export (each also takes --device).
            "relgat-projector-cuda-export="
            "relgat_projector_tpu_torch.export:main",
            "relgat-projector-cuda-import-reference="
            "relgat_projector_tpu_torch.interop:main",
            "relgat-projector-cuda-export-reference="
            "relgat_projector_tpu_torch.interop:main_export",
        ]
    },
)

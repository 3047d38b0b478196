"""tdgs_torch — the PyTorch/CUDA port of tdgs for NVIDIA Hopper.

The JAX package ``tdgs`` stays the reference; this package mirrors its
layout (``ops/``, ``physics/``, ``models/``, ``strategy/``, ``training/``,
``datasets/``, ``utils/``, ``parallel/``, ``rendering.py``, ``pipeline.py``)
and never imports it or JAX. Plain tensor code is
PyTorch; each Pallas kernel of the JAX package becomes a hand-written CUDA
kernel under ``csrc/``, built by ``nvcc`` on first use.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.
"""

import torch

# True float32 everywhere. The geometry here cancels large terms (EWA
# conics, SAT depths; the JAX package's eval3d kernels document σ* chains
# cancelling ~1e4-magnitude quadratic forms), which the TPU's bf16 matmul
# passes broke. TF32 is the Hopper form of that hazard, so it stays off
# for matmuls and for cuDNN convolutions alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from tdgs_torch.compression import PngCompression  # noqa: E402
from tdgs_torch.ops.adam import SelectiveAdam, selective_adam  # noqa: E402
from tdgs_torch.ops.camera_models import RollingShutterType  # noqa: E402
from tdgs_torch.ops.indices import (  # noqa: E402
    accumulate,
    accumulate_2dgs,
    rasterize_to_indices_in_range,
    rasterize_to_indices_in_range_2dgs,
)
from tdgs_torch.ops.projection import fully_fused_projection, proj  # noqa: E402
from tdgs_torch.ops.projection_2dgs import fully_fused_projection_2dgs  # noqa: E402
from tdgs_torch.ops.projection_ut import fully_fused_projection_with_ut  # noqa: E402
from tdgs_torch.ops.rasterize_2dgs_jax import (  # noqa: E402
    rasterize_to_pixels_2dgs_jax as rasterize_to_pixels_2dgs,
)
from tdgs_torch.ops.rasterize_eval3d import (  # noqa: E402
    rasterize_to_pixels_eval3d_jax as rasterize_to_pixels_eval3d,
)
from tdgs_torch.ops.rasterize_jax import (  # noqa: E402
    rasterize_to_pixels_jax as rasterize_to_pixels,
)
from tdgs_torch.ops.rasterize_pallas import rasterize_to_pixels_pallas  # noqa: E402
from tdgs_torch.ops.rasterize_packed import (  # noqa: E402
    rasterize_to_pixels_packed,
    rasterize_to_pixels_packed_inference,
    rasterize_to_pixels_packed_inference_plain,
)
from tdgs_torch.ops.relocation import compute_relocation  # noqa: E402
from tdgs_torch.ops.sh import spherical_harmonics  # noqa: E402
from tdgs_torch.ops.tiling import (  # noqa: E402
    isect_offset_encode,
    isect_tiles,
    isect_tiles_packed,
)
from tdgs_torch.ops.transforms import (  # noqa: E402
    quat_scale_to_covar_preci,
    quat_to_rotmat,
    world_to_cam,
)
from tdgs_torch.rendering import (  # noqa: E402
    rasterization,
    rasterization_2dgs,
    rasterization_2dgs_inria_wrapper,
    rasterization_inria_wrapper,
)
from tdgs_torch.strategy import DefaultStrategy, MCMCStrategy, Strategy  # noqa: E402
from tdgs_torch.utils.ply import export_splats  # noqa: E402

__version__ = "0.1.0"

# every name of the JAX package's ``tdgs.__all__``, then the port's own
__all__ = [
    "PngCompression",
    "DefaultStrategy",
    "MCMCStrategy",
    "Strategy",
    "rasterization",
    "rasterization_2dgs",
    "rasterization_inria_wrapper",
    "rasterization_2dgs_inria_wrapper",
    "spherical_harmonics",
    "isect_offset_encode",
    "isect_tiles",
    "proj",
    "fully_fused_projection",
    "quat_scale_to_covar_preci",
    "quat_to_rotmat",
    "rasterize_to_pixels",
    "world_to_cam",
    "accumulate",
    "rasterize_to_indices_in_range",
    "fully_fused_projection_2dgs",
    "rasterize_to_pixels_2dgs",
    "rasterize_to_indices_in_range_2dgs",
    "accumulate_2dgs",
    "RollingShutterType",
    "fully_fused_projection_with_ut",
    "rasterize_to_pixels_eval3d",
    "SelectiveAdam",
    "selective_adam",
    "compute_relocation",
    "export_splats",
    "__version__",
    "isect_tiles_packed",
    "rasterize_to_pixels_pallas",
    "rasterize_to_pixels_packed",
    "rasterize_to_pixels_packed_inference",
    "rasterize_to_pixels_packed_inference_plain",
]

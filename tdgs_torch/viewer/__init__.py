"""The splat viewer (port of ``tdgs/viewer``): an HTTP server streaming
JPEG frames of a render function to a browser page."""

from tdgs_torch.viewer.server import (
    RenderTabState,
    ViewerServer,
    fly_camera,
    make_splat_render_fn,
    orbit_camera,
)

__all__ = ["RenderTabState", "ViewerServer", "fly_camera", "make_splat_render_fn",
           "orbit_camera"]

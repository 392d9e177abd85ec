from .cameras import (
    DTUCamera, FoVPerspectiveCamera, NeRFCamera, NeRFMMCamera, NeRVCamera,
    camera_position_from_spherical_angles, lift, look_at_rotation,
    look_at_view_transform, nerf_c2w, spherical_positions,
)

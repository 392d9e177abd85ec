from .cameras import (
    FoVPerspectiveCamera, NeRFCamera, camera_position_from_spherical_angles,
    look_at_rotation, look_at_view_transform, nerf_c2w,
)

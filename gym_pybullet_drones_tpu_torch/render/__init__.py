from gym_pybullet_drones_tpu_torch.render.camera import (
    CameraConfig,
    export_image,
    render_drone_views,
)

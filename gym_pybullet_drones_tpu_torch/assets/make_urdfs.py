"""Generate reference-format URDF assets from the built-in parameter tables
(the port's copy of the JAX package's ``assets/make_urdfs.py``).

The reference stores all physics coefficients in custom `<properties>` tags of
its URDFs (assets/cf2x.urdf:5 etc.); `core/params.from_urdf` reads that format
by tag/attribute name. These assets are written fresh from `_MODEL_TABLE` so
user tooling that consumes reference-style URDFs keeps working, and round-trip
equality (`from_urdf(asset) == drone_params(model)`) is enforced in
tests/test_params.py (tests/test_torch_params.py holds the
port's `from_urdf` against the JAX package's).

Run `python -m gym_pybullet_drones_tpu_torch.assets.make_urdfs` to regenerate.
"""

import os

from gym_pybullet_drones_tpu_torch.core.params import _MODEL_TABLE

HERE = os.path.dirname(os.path.abspath(__file__))

_TEMPLATE = """<?xml version="1.0" ?>

<robot name="{name}">

  <properties arm="{arm}" kf="{kf}" km="{km}" thrust2weight="{thrust2weight}" max_speed_kmh="{max_speed_kmh}" gnd_eff_coeff="{gnd_eff_coeff}" prop_radius="{prop_radius}" drag_coeff_xy="{drag_coeff_xy}" drag_coeff_z="{drag_coeff_z}" dw_coeff_1="{dw_coeff_1}" dw_coeff_2="{dw_coeff_2}" dw_coeff_3="{dw_coeff_3}" />

  <link name="base_link">
    <inertial>
      <origin rpy="0 0 0" xyz="0 0 0"/>
      <mass value="{m}"/>
      <inertia ixx="{ixx}" ixy="0.0" ixz="0.0" iyy="{iyy}" iyz="0.0" izz="{izz}"/>
    </inertial>
    <visual>
      <origin rpy="0 0 0" xyz="0 0 0"/>
      <geometry>
        <cylinder radius="{collision_r}" length="{collision_h}"/>
      </geometry>
    </visual>
    <collision>
      <origin rpy="0 0 0" xyz="0 0 {collision_z_offset}"/>
      <geometry>
        <cylinder radius="{collision_r}" length="{collision_h}"/>
      </geometry>
    </collision>
  </link>

{prop_links}
</robot>
"""

_PROP_TEMPLATE = """  <link name="prop{i}_link">
    <inertial>
      <origin rpy="0 0 0" xyz="{x} {y} {z}"/>
      <mass value="0"/>
      <inertia ixx="0" ixy="0" ixz="0" iyy="0" iyz="0" izz="0"/>
    </inertial>
  </link>
  <joint name="prop{i}_joint" type="fixed">
    <parent link="base_link"/>
    <child link="prop{i}_link"/>
  </joint>
"""


def write_urdfs(out_dir: str = HERE):
    paths = {}
    for model, table in _MODEL_TABLE.items():
        prop_links = "\n".join(
            _PROP_TEMPLATE.format(i=i, x=off[0], y=off[1], z=off[2])
            for i, off in enumerate(table["prop_offsets"])
        )
        content = _TEMPLATE.format(name=model.value, prop_links=prop_links,
                                   **{k: v for k, v in table.items()
                                      if k != "prop_offsets"})
        path = os.path.join(out_dir, f"{model.value}.urdf")
        with open(path, "w") as f:
            f.write(content)
        paths[model] = path
    return paths


if __name__ == "__main__":
    for model, path in write_urdfs().items():
        print(model, "->", path)

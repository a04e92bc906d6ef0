"""Minimal URDF reader: the repo's asset files → scene constants.  Port of
cartpoleplusplus_tpu.physics.urdf.

The scene is three analytic shapes, so "importing" a URDF means parsing
masses, box sizes and friction coefficients out of the XML once on the
host into :class:`bodies.SceneParams`.  Supported subset (all this scene
uses): one <link> per file with a <box size> or <plane> collision
geometry, <inertial><mass value>, <contact_coefficients mu>, and this
package's ``top_contact_coefficients`` extension for the cart's distinct
top-face friction.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional

from cartpoleplusplus_tpu_torch.physics.bodies import SceneParams, make_scene


class UrdfBody:
    """Parsed constants of one URDF file."""

    def __init__(self, name: str, box_size: Optional[tuple[float, float, float]], mass: float,
                 mu: float, top_mu: Optional[float] = None, is_plane: bool = False):
        self.name = name
        self.box_size = box_size
        self.mass = mass
        self.mu = mu
        self.top_mu = top_mu
        self.is_plane = is_plane

    @property
    def half_extents(self) -> tuple[float, float, float]:
        assert self.box_size is not None, f"{self.name} has no box geometry"
        return tuple(s / 2.0 for s in self.box_size)


def parse_urdf(path: str) -> UrdfBody:
    """Parse the supported URDF subset from one file."""
    robot = ET.parse(path).getroot()
    if robot.tag != "robot":
        raise ValueError(f"{path}: expected <robot> root, got <{robot.tag}>")
    link = robot.find("link")
    if link is None:
        raise ValueError(f"{path}: no <link>")

    mass = 0.0
    mass_el = link.find("inertial/mass")
    if mass_el is not None:
        mass = float(mass_el.get("value", "0"))

    box_size, is_plane, mu, top_mu = None, False, 0.5, None
    collision = link.find("collision")
    if collision is not None:
        geom = collision.find("geometry")
        if geom is not None:
            box = geom.find("box")
            if box is not None:
                box_size = tuple(float(v) for v in box.get("size").split())
            is_plane = geom.find("plane") is not None
        cc = collision.find("contact_coefficients")
        if cc is not None:
            mu = float(cc.get("mu", "0.5"))
        tcc = collision.find("top_contact_coefficients")
        if tcc is not None:
            top_mu = float(tcc.get("mu"))

    return UrdfBody(name=robot.get("name", os.path.basename(path)), box_size=box_size,
                    mass=mass, mu=mu, top_mu=top_mu, is_plane=is_plane)


def scene_from_urdf_dir(asset_dir: str, **overrides) -> SceneParams:
    """ground/cart/pole URDFs → SceneParams.

    Pairwise frictions are the product of the two bodies' coefficients
    (Bullet's convention), except that a cart ``top_contact_coefficients``
    gives the pole↔cart-top pair's coefficient directly.  ``overrides``
    pass through to :func:`bodies.make_scene` (dt, solver iterations, …).
    """
    ground = parse_urdf(os.path.join(asset_dir, "ground.urdf"))
    cart = parse_urdf(os.path.join(asset_dir, "cart.urdf"))
    pole = parse_urdf(os.path.join(asset_dir, "pole.urdf"))
    if not ground.is_plane:
        raise ValueError("ground.urdf must contain a plane geometry")
    kwargs = dict(
        cart_half_extents=cart.half_extents,
        pole_half_extents=pole.half_extents,
        cart_mass=cart.mass,
        pole_mass=pole.mass,
        friction_cart_ground=cart.mu * ground.mu,
        friction_pole_cart=cart.top_mu if cart.top_mu is not None else pole.mu * cart.mu,
        friction_pole_ground=pole.mu * ground.mu,
    )
    kwargs.update(overrides)
    return make_scene(**kwargs)


def default_asset_dir() -> str:
    """The repo's ``assets/`` directory."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "assets")

"""Minimal URDF -> `SerialChain` reader, plain Python and numpy (twin of
`biped_pympc_tpu/models/urdf.py`).

The per-joint origin translations and rotation axes along the root -> tip
path are read from the URDF XML and packed into a `models.chain.SerialChain`.

Scope, the class of chains the MPC stack uses:
  * every joint on the path is `revolute` / `continuous` about a positive
    principal axis (+x / +y / +z), or `fixed`, or listed in `locked`
    (taken as fixed at q = 0);
  * every origin on the path has rpy == 0 (a pure translation), as on the
    T1 legs; a chain outside this class raises ValueError.

Fixed and locked translations fold into the next moving joint's offset
(exact when rpy == 0 and the locked angle is 0); a trailing fixed
transform (the foot sole) becomes the tip offset, and any prefix before the
first moving joint the base offset.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from biped_pympc_tpu_torch.models.chain import SerialChain

_AXES = {
    (1.0, 0.0, 0.0): "x",
    (0.0, 1.0, 0.0): "y",
    (0.0, 0.0, 1.0): "z",
}

# The kinematics-only T1 model this package ships (`models/assets/`, byte for
# byte the JAX package's asset).
T1_FIXTURE_URDF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                               "t1_kinematics.urdf")


def _vec3(s: str | None) -> np.ndarray:
    if not s:
        return np.zeros(3)
    return np.array([float(v) for v in s.split()])


def chain_from_urdf(urdf_path: str, root_link: str, tip_link: str,
                    locked: tuple[str, ...] = ()) -> SerialChain:
    """The serial chain from `root_link` to `tip_link`; `locked` names
    joints taken as fixed at q = 0."""
    root = ET.parse(urdf_path).getroot()
    by_child: dict[str, ET.Element] = {}
    for j in root.findall("joint"):
        by_child[j.find("child").get("link")] = j

    # Walk tip -> root through the parent links, then reverse.
    path: list[ET.Element] = []
    link = tip_link
    while link != root_link:
        j = by_child.get(link)
        if j is None:
            raise ValueError(f"no joint chain from '{root_link}' to '{tip_link}' "
                             f"(dead end at link '{link}')")
        path.append(j)
        link = j.find("parent").get("link")
    path.reverse()

    base_offset = None  # fixed prefix before the first moving joint
    pending = np.zeros(3)  # accumulated fixed / locked translation
    offsets: list[np.ndarray] = []
    axes = ""
    for j in path:
        name = j.get("name")
        origin = j.find("origin")
        xyz = _vec3(origin.get("xyz") if origin is not None else None)
        rpy = _vec3(origin.get("rpy") if origin is not None else None)
        if np.any(rpy != 0.0):
            raise ValueError(f"joint '{name}' has rpy={rpy.tolist()}; only pure-translation "
                             "origins are supported by SerialChain")
        jtype = j.get("type")
        if jtype == "fixed" or name in locked:
            pending = pending + xyz
            continue
        if jtype not in ("revolute", "continuous"):
            raise ValueError(f"unsupported joint type '{jtype}' at '{name}'")
        axis = tuple(_vec3(j.find("axis").get("xyz")))
        if axis not in _AXES:
            raise ValueError(f"joint '{name}' axis {list(axis)} is not a positive principal "
                             "axis (+x/+y/+z)")
        if base_offset is None:
            base_offset = pending
            offsets.append(xyz)
        else:
            offsets.append(pending + xyz)
        pending = np.zeros(3)
        axes += _AXES[axis]

    if not axes:
        raise ValueError(f"no movable joints between '{root_link}' and '{tip_link}'")
    return SerialChain(base_offset=base_offset, joint_offsets=np.array(offsets), axes=axes,
                       tip_offset=pending)

"""Plain kinematics and constants of the two bipeds the benchmark runs, in
any float dtype: HECTOR (5 DoF a leg) and the Booster T1 (6 DoF a leg, its
serial chain read from the URDF beside this file).

A frozen copy of the published robot descriptions as the program under test
states them; it imports nothing of that program. Every function is batched
over a leading axis and works on whatever device its inputs lie on.
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

T1_URDF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "t1_kinematics.urdf")


def _mat3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_x(a):
    c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
    return _mat3([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(a):
    c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
    return _mat3([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(a):
    c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
    return _mat3([[c, -s, z], [s, c, z], [z, z, o]])


_ROT = {"x": rot_x, "y": rot_y, "z": rot_z}


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def _c(value, like):
    return torch.as_tensor(np.asarray(value, np.float64), dtype=like.dtype, device=like.device)


@dataclass(frozen=True)
class Robot:
    """Constants and per-leg kinematics (leg 0 left, 1 right)."""

    name: str
    num_dof: int
    mass: float
    i_body: np.ndarray
    mu: float
    lt: float
    lh: float
    kp: tuple
    kd: tuple
    torque_limit: tuple
    frames: Callable  # (q (B, dof), leg) -> (p (B, 3), origins (B, dof, 3), axes (B, dof, 3))
    ik: Callable  # (p (B, 3), leg) -> q (B, dof)
    hip: tuple  # per leg the (3,) hip point of the Raibert heuristic

    def foot(self, q, leg):
        return self.frames(q, leg)[0]

    def jacobian(self, q, leg):
        """(B, 6, dof): linear rows a_i x (p - o_i), angular rows a_i."""
        p, origins, axes = self.frames(q, leg)
        lin = torch.linalg.cross(axes, p[:, None, :] - origins, dim=-1)
        return torch.cat([lin.transpose(-1, -2), axes.transpose(-1, -2)], dim=1)


# HECTOR: link offsets and frame permutations of its published model.
_H_P1 = np.array([-0.00, 0.047, -0.1265])
_H_P2 = np.array([0.0465, 0.015, -0.0705])
_H_P3 = np.array([-0.06, 0.018, 0.0])
_H_P4 = np.array([0.0, 0.01805, -0.22])
_H_P5 = np.array([0.0, 0.00, -0.22])
_H_P5E = np.array([0.0, 0.0, -0.042])
_H_R12 = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], dtype=np.float64)
_H_R23 = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=np.float64)


def _hector_frames(q, leg):
    my = np.array([1.0, -1.0, 1.0]) if leg else np.ones(3)
    mz = np.array([1.0, 1.0, -1.0]) if leg else np.ones(3)
    r12, r23 = _c(_H_R12, q), _c(_H_R23, q)
    r_b = _H_R23.T @ _H_R12.T
    r01 = rot_z(q[:, 0])
    t01 = _c(_H_P1 * my, q).expand(q.shape[0], 3)
    r02 = r01 @ r12 @ rot_z(q[:, 1])
    t02 = t01 + _mv(r01 @ r12, _c(_H_R12.T @ _H_P2 * my, q))
    r03 = r02 @ r23 @ rot_z(q[:, 2])
    t03 = t02 + _mv(r02 @ r23, _c(r_b @ _H_P3 * mz, q))
    r04 = r03 @ rot_z(q[:, 3])
    t04 = t03 + _mv(r03, _c(r_b @ _H_P4 * mz, q))
    r05 = r04 @ rot_z(q[:, 4])
    t05 = t04 + _mv(r04, _c(r_b @ _H_P5 * mz, q))
    p = t05 + _mv(r05, _c(r_b @ _H_P5E, q))
    origins = torch.stack([t01, t02, t03, t04, t05], dim=1)
    axes = torch.stack([r[..., 2] for r in (r01, r02, r03, r04, r05)], dim=1)
    return p, origins, axes


def _hector_ik(p, leg):
    """Closed-form IK: hip yaw 0, the ankle keeps the sole level with the torso."""
    side = 1.0 if leg == 1 else -1.0
    foot = p - _c((-0.00 + 0.0465 - 0.06, -side * (0.047 + 0.015), -0.126 - 0.0705), p)
    foot = foot + _c((0.0, 0.0, 0.042), p)
    thigh = calf = 0.22
    dist_yz = torch.sqrt(foot[:, 1] ** 2 + foot[:, 2] ** 2)
    q1 = (torch.asin(torch.clamp(foot[:, 1] / dist_yz, -1.0, 1.0))
          + torch.asin(torch.clamp((0.018 + 0.01805) * side / dist_yz, -1.0, 1.0)))
    foot_hp = _mv(rot_x(q1), foot) + _c((0.0, 0.018 * side, 0.0), p)
    r = torch.linalg.vector_norm(foot_hp, dim=-1)
    cos_k = torch.clamp((r ** 2 - thigh ** 2 - calf ** 2) / (2.0 * thigh * calf), -1.0, 1.0)
    sin_k = torch.clamp(-torch.sqrt(torch.clamp(1.0 - cos_k ** 2, min=1e-6)), -1.0, 1.0)
    knee = torch.atan2(sin_k, cos_k)
    pitch = (torch.atan2(-foot_hp[:, 0], -foot_hp[:, 2])
             - torch.atan2(calf * sin_k, thigh + calf * cos_k))
    return torch.stack([torch.zeros_like(q1), q1, pitch, knee, -pitch - knee], dim=-1)


HECTOR = Robot(
    name="HECTOR", num_dof=5, mass=13.856,
    i_body=np.array([[0.5413, 0.0, 0.0], [0.0, 0.5200, 0.0], [0.0, 0.0, 0.0691]]),
    mu=1.0, lt=0.07, lh=0.04, kp=(40.0, 40.0, 70.0, 70.0, 40.0), kd=(1.0, 1.0, 0.7, 0.7, 0.7),
    torque_limit=(33.5, 33.5, 33.5, 67.0, 33.5) * 2, frames=_hector_frames, ik=_hector_ik,
    hip=((-0.0135, 0.098, 0.0), (-0.0135, -0.098, 0.0)))


def urdf_chain(path: str, root_link: str, tip_link: str, locked=()):
    """(base offset, joint offsets (n, 3), axes "xyz..", tip offset) of the
    revolute chain root -> tip; every origin a pure translation, every axis
    a positive principal one; fixed and locked joints folded into the next."""
    joints = {j.find("child").get("link"): j for j in ET.parse(path).getroot().findall("joint")}
    path_j, link = [], tip_link
    while link != root_link:
        j = joints[link]
        path_j.append(j)
        link = j.find("parent").get("link")
    vec = lambda s: np.array([float(v) for v in s.split()]) if s else np.zeros(3)
    base, pending, offsets, axes = None, np.zeros(3), [], ""
    for j in reversed(path_j):
        origin = j.find("origin")
        if np.any(vec(origin.get("rpy"))):
            raise ValueError(f"{j.get('name')}: rotated origins are outside this reader")
        if j.get("type") == "fixed" or j.get("name") in locked:
            pending = pending + vec(origin.get("xyz"))
            continue
        axis = vec(j.find("axis").get("xyz"))
        axes += "xyz"[int(np.argmax(axis))]
        if base is None:
            base, step = pending, vec(origin.get("xyz"))
        else:
            step = pending + vec(origin.get("xyz"))
        offsets.append(step)
        pending = np.zeros(3)
    return base, np.array(offsets), axes, pending


_T1_CHAINS = tuple(urdf_chain(T1_URDF, "Trunk", tip, locked=("Waist",))
                   for tip in ("left_foot_sole_link", "right_foot_sole_link"))


def _t1_frames(q, leg):
    base, offsets, axes_s, tip = _T1_CHAINS[leg]
    nb = q.shape[0]
    r = _c(np.eye(3), q).expand(nb, 3, 3)
    t = _c(base, q).expand(nb, 3)
    origins, axes = [], []
    for i, ax in enumerate(axes_s):
        t = t + _mv(r, _c(offsets[i], q))
        origins.append(t)
        r = r @ _ROT[ax](q[:, i])
        axes.append(r[..., "xyz".index(ax)])
    return t + _mv(r, _c(tip, q)), torch.stack(origins, 1), torch.stack(axes, 1)


def _t1_ik(p, leg):
    """The planar closed form: hip yaw and ankle roll 0, with its clips and
    1e-6 epsilons."""
    side = 1.0 if leg == 0 else -1.0
    l1, l2, knee_x = 0.02 + 0.081854 + 0.134, 0.28 + 0.012, -0.014
    v = p - _c((0.0625, side * 0.106, -0.1155), p) - _c((0.0, side * 0.00025, -0.035192), p)
    roll = torch.atan2(v[:, 1], -v[:, 2])
    xs = v[:, 0] - knee_x
    zs = -v[:, 1] * torch.sin(roll) + v[:, 2] * torch.cos(roll)
    d = torch.sqrt(xs * xs + zs * zs)
    beta = torch.arccos(torch.clamp((l1 * l1 + d * d - l2 * l2) / (2 * l1 * d + 1e-6), -1.0, 1.0))
    knee = math.pi - torch.arccos(torch.clamp((l1 * l1 + l2 * l2 - d * d) / (2 * l1 * l2 + 1e-6),
                                              -1.0, 1.0))
    pitch = torch.atan2(xs, -zs) - beta
    zero = torch.zeros_like(pitch)
    return torch.stack([pitch, roll, zero, knee, -(pitch + knee), zero], dim=-1)


T1 = Robot(
    name="T1", num_dof=6, mass=40.0,
    i_body=np.array([[0.5413, 0.0, 0.0], [0.0, 0.5200, 0.0], [0.0, 0.0, 0.0691]]),
    mu=1.0, lt=0.1215, lh=0.1015, kp=(20.0, 20.0, 20.0, 20.0, 15.0, 15.0),
    kd=(1.0, 1.0, 0.7, 0.7, 0.7, 0.7), torque_limit=(33.5, 33.5, 33.5, 67.0, 33.5, 33.5) * 2,
    frames=_t1_frames, ik=_t1_ik, hip=((0.0485, 0.106, 0.0), (0.0485, -0.106, 0.0)))

ROBOTS = {"HECTOR": HECTOR, "T1": T1}

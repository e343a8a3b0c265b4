"""Structure-of-arrays scene model (port of ``raytracer_js_tpu.models.scene``).

Flat parameter tensors — ``sphere_center [S,3]``, ``sphere_radius [S]``,
``box_center/box_half [B,3]``, triangle vertices ``[T,3]`` — plus
per-primitive id columns into the material / texture / substance tables.
Global primitive ids are ordered [spheres | boxes | triangles]; every
nearest-hit path returns ids in this space.

A :class:`Scene` is a plain dataclass of tensors that all live on one
device (:attr:`Scene.device`); :meth:`Scene.to` moves it. Its float
tensors are the differentiable leaves (:func:`float_partition`,
:func:`float_leaf_names`), and :func:`records_grad` says whether autograd
would record through a scene: the backends without a backward refuse such
calls (``ops/trace.refuse_grad``) and the shade kernel declines them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import ResponseType, TextureKind, resolve_device
from .materials import MaterialTable, make_material_table
from .textures import TextureTable

Tensor = torch.Tensor

#: substance id meaning "undefined": transmission through such an entity does
#: not refract and does not change the ray's substance (raytracer.ts:243-248)
SUBSTANCE_UNDEFINED = -1

# Reference canned substances (substance.ts:1-11).
REFR_AIR = 1.0
REFR_WATER = 1.333
REFR_GLASS = 1.5

_GEOMETRY = ("sphere_center", "sphere_radius", "box_center", "box_half",
             "tri_v0", "tri_v1", "tri_v2", "prim_material", "prim_texture",
             "prim_substance", "sub_refr", "default_refr")


@dataclasses.dataclass(frozen=True)
class Scene:
    sphere_center: Tensor   # [S, 3]
    sphere_radius: Tensor   # [S]
    box_center: Tensor      # [B, 3]
    box_half: Tensor        # [B, 3]
    tri_v0: Tensor          # [T, 3]
    tri_v1: Tensor          # [T, 3]
    tri_v2: Tensor          # [T, 3]
    prim_material: Tensor   # [P] i32
    prim_texture: Tensor    # [P] i32
    prim_substance: Tensor  # [P] i32 (SUBSTANCE_UNDEFINED allowed)
    materials: MaterialTable
    textures: TextureTable
    sub_refr: Tensor        # [K] f32 refractive indices
    default_refr: Tensor    # [] f32: empty-space substance
    sky_tex: int = 0
    #: cube-map sky: 6 texture ids (+x, -x, +y, -y, +z, -z faces) or None
    #: (see ops/trace.sky_color for the face convention)
    sky_box: Optional[tuple] = None
    has_transmission: bool = True
    has_rough: bool = True
    #: any material declares ResponseType.BOTH (implies has_transmission)
    has_both: bool = False

    def __post_init__(self):
        if self.has_both and not self.has_transmission:
            raise ValueError("has_both requires has_transmission: BOTH rides "
                             "the transmission machinery")

    @property
    def n_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def n_boxes(self) -> int:
        return self.box_center.shape[0]

    @property
    def n_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def n_prims(self) -> int:
        return self.n_spheres + self.n_boxes + self.n_tris

    @property
    def device(self) -> torch.device:
        return self.sphere_center.device

    def to(self, device) -> "Scene":
        moved = {k: getattr(self, k).to(device) for k in _GEOMETRY}
        return dataclasses.replace(self, **moved,
                                   materials=self.materials.to(device),
                                   textures=self.textures.to(device))


def prim_aabbs(scene: Scene) -> Tuple[Tensor, Tensor]:
    """Per-primitive AABBs -> (lo [P,3], hi [P,3]) in global prim order."""
    r = scene.sphere_radius[:, None]
    lo = torch.cat([scene.sphere_center - r,
                    scene.box_center - scene.box_half,
                    torch.minimum(torch.minimum(scene.tri_v0, scene.tri_v1),
                                  scene.tri_v2)], dim=0)
    hi = torch.cat([scene.sphere_center + r,
                    scene.box_center + scene.box_half,
                    torch.maximum(torch.maximum(scene.tri_v0, scene.tri_v1),
                                  scene.tri_v2)], dim=0)
    return lo, hi


def sphere_volumes(radius: Tensor) -> Tensor:
    return (4.0 / 3.0) * math.pi * (radius * radius * radius)


def box_volumes(half: Tensor) -> Tensor:
    e = 2.0 * half
    return e[:, 0] * e[:, 1] * e[:, 2]


def prim_volumes(scene: Scene) -> Tensor:
    """Enclosed volume per primitive (triangles: 0 — no interior); the
    innermost-containing-entity rule of the substance query uses it."""
    t_vol = torch.zeros((scene.n_tris,), dtype=torch.float32,
                        device=scene.device)
    return torch.cat([sphere_volumes(scene.sphere_radius),
                      box_volumes(scene.box_half), t_vol], dim=0)


# ---------------------------------------------------------------------------
# Differentiable-parameter partition
# ---------------------------------------------------------------------------

def _float_paths(obj, prefix=()) -> List[tuple]:
    """Field paths of the floating-point tensors of a (nested) dataclass,
    in field-declaration order."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out += _float_paths(v, prefix + (f.name,))
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            out.append(prefix + (f.name,))
    return out


def _get(obj, path):
    for name in path:
        obj = getattr(obj, name)
    return obj


def _replace(obj, path, value):
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    inner = getattr(obj, path[0])
    return dataclasses.replace(
        obj, **{path[0]: _replace(inner, path[1:], value)})


def float_leaf_names(scene: Scene) -> List[str]:
    """Dotted field names of :func:`float_partition`'s params, in order."""
    return [".".join(p) for p in _float_paths(scene)]


def records_grad(scene: Scene, *tensors: Tensor) -> bool:
    """Whether autograd would record a computation on ``scene`` and
    ``tensors``: grad is enabled and one of ``tensors`` or a float tensor
    of the scene (:func:`float_partition`'s params) requires grad."""
    if not torch.is_grad_enabled():
        return False
    return (any(t.requires_grad for t in tensors)
            or any(_get(scene, p).requires_grad for p in _float_paths(scene)))


def float_partition(scene: Scene) -> Tuple[List[Tensor],
                                            Callable[[list], Scene]]:
    """Split a scene into ``(params, rebuild)``.

    ``params`` lists the float tensors — the differentiable degrees of
    freedom — in the reference package's pytree order: ``sphere_center,
    sphere_radius, box_center, box_half, tri_v0, tri_v1, tri_v2,
    materials.roughness, textures.solid_rgb, textures.atlas, sub_refr,
    default_refr``. ``rebuild(new_params)`` returns the scene with those
    tensors replaced; integer id columns and static fields stay.
    """
    paths = _float_paths(scene)
    params = [_get(scene, p) for p in paths]

    def rebuild(new_params) -> Scene:
        new_params = list(new_params)
        if len(new_params) != len(paths):
            raise ValueError(f"expected {len(paths)} params, got "
                             f"{len(new_params)}")
        out = scene
        for p, v in zip(paths, new_params):
            out = _replace(out, p, v)
        return out

    return params, rebuild



def scene_from_numpy(arrays: dict, *, sky_tex: int, has_transmission: bool,
                     has_rough: bool, has_both: bool, has_images: bool,
                     has_bilinear: bool, sky_box: Optional[tuple] = None,
                     device=None) -> Scene:
    """Build a :class:`Scene` from numpy arrays named like the reference
    package's ``Scene`` fields.

    ``arrays`` holds the primitive arrays and id columns under their field
    names (``sphere_center`` ... ``prim_substance``), the tables as
    ``materials.response``, ``materials.light``, ``materials.mirror``,
    ``materials.roughness``, ``textures.kind``, ``textures.ref``,
    ``textures.solid_rgb``, ``textures.atlas``, ``textures.img_h``,
    ``textures.img_w``, and ``sub_refr`` and ``default_refr``. ``device``
    defaults to the card (``config.resolve_device``).
    """
    device = resolve_device(device)

    def t(name, dtype):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype,
                               device=device)

    f32, i32 = torch.float32, torch.int32
    geom = {k: t(k, f32) for k in ("sphere_center", "sphere_radius",
                                   "box_center", "box_half", "tri_v0",
                                   "tri_v1", "tri_v2", "sub_refr",
                                   "default_refr")}
    for k in ("sphere_center", "box_center", "box_half", "tri_v0", "tri_v1",
              "tri_v2"):
        geom[k] = geom[k].reshape(-1, 3)
    return Scene(
        **geom,
        prim_material=t("prim_material", i32),
        prim_texture=t("prim_texture", i32),
        prim_substance=t("prim_substance", i32),
        materials=MaterialTable(
            response=t("materials.response", i32),
            light=t("materials.light", torch.bool),
            mirror=t("materials.mirror", torch.bool),
            roughness=t("materials.roughness", f32)),
        textures=TextureTable(kind=t("textures.kind", i32),
                              ref=t("textures.ref", i32),
                              solid_rgb=t("textures.solid_rgb", f32),
                              atlas=t("textures.atlas", f32),
                              img_h=t("textures.img_h", i32),
                              img_w=t("textures.img_w", i32),
                              has_images=bool(has_images),
                              has_bilinear=bool(has_bilinear)),
        sky_tex=int(sky_tex),
        sky_box=None if sky_box is None else tuple(int(i) for i in sky_box),
        has_transmission=bool(has_transmission),
        has_rough=bool(has_rough), has_both=bool(has_both))


class SceneBuilder:
    """Host-side scene assembly (reference main.ts:341-433 scene setup).

    All adders return integer ids; :meth:`build` freezes everything into a
    :class:`Scene` on the requested device, the card by default
    (``build(device="cpu")`` for the CPU).
    """

    def __init__(self, atlas_hw: Optional[Tuple[int, int]] = None):
        #: fixed atlas resolution images are nearest-resized to, or None
        #: (the default): every image keeps its native resolution and the
        #: atlas pads to the largest (texture_image.ts:40-63)
        self.atlas_hw = atlas_hw
        self._materials: List[tuple] = []
        self._tex_kind: List[int] = []
        self._tex_ref: List[int] = []
        self._tex_solid: List[np.ndarray] = []
        self._images: List[np.ndarray] = []
        self._substances: List[float] = []
        self._spheres: List[tuple] = []   # (center, radius, mat, tex, sub)
        self._boxes: List[tuple] = []     # (center, half, mat, tex, sub)
        self._tris: List[tuple] = []      # (v0, v1, v2, mat, tex, sub)
        self._sky_tex: Optional[int] = None
        self._sky_box: Optional[tuple] = None
        self._default_refr: float = REFR_AIR

    # -- tables ------------------------------------------------------------
    def add_material(self, response: ResponseType = ResponseType.REFLECTION,
                     light: bool = False, mirror: bool = False,
                     roughness: float = 0.0) -> int:
        self._materials.append((response, light, mirror, roughness))
        return len(self._materials) - 1

    def add_solid_texture(self, rgb) -> int:
        """SolidTexture (texture_solid.ts:21-44)."""
        self._tex_kind.append(int(TextureKind.SOLID))
        self._tex_ref.append(0)
        self._tex_solid.append(np.asarray(rgb, np.float32).reshape(3))
        return len(self._tex_kind) - 1

    def add_image_texture(self, image, fallback=(0.0, 0.0, 0.0),
                          bilinear: bool = False) -> int:
        """ImageTexture (texture_image.ts:20-137): ``image`` is [H, W, 3]
        float in [0, 1], nearest-resized to ``atlas_hw`` when the builder
        has one. ``fallback`` is the reference's until-loaded color;
        ``bilinear=True`` opts into 4-tap filtered sampling."""
        img = np.asarray(image, np.float32)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"an image texture is [H, W, 3], got "
                             f"{img.shape}")
        if self.atlas_hw is not None:
            ah, aw = self.atlas_hw
            if img.shape[:2] != (ah, aw):
                yi = np.arange(ah) * img.shape[0] // ah
                xi = np.arange(aw) * img.shape[1] // aw
                img = img[yi][:, xi]
        self._images.append(img)
        self._tex_kind.append(int(TextureKind.IMAGE_BILINEAR if bilinear
                                  else TextureKind.IMAGE))
        self._tex_ref.append(len(self._images) - 1)
        self._tex_solid.append(np.asarray(fallback, np.float32).reshape(3))
        return len(self._tex_kind) - 1

    def add_substance(self, refractive_index: float) -> int:
        self._substances.append(float(refractive_index))
        return len(self._substances) - 1

    def set_sky(self, tex_id: int) -> None:
        """Equirect sky texture (sky/sky_sphere.ts:22-27); clears a sky
        box."""
        self._sky_tex = tex_id
        self._sky_box = None

    def set_sky_box(self, face_tex_ids) -> None:
        """Cube-map sky from 6 texture ids, face order
        (+x, -x, +y, -y, +z, -z); completes the reference's SkyBox stub
        (sky/sky_box.ts:17)."""
        ids = tuple(int(i) for i in face_tex_ids)
        if len(ids) != 6:
            raise ValueError(f"a sky box has 6 faces, got {len(ids)}")
        self._sky_box = ids

    def set_default_refr(self, refr: float) -> None:
        self._default_refr = float(refr)

    # -- primitives ----------------------------------------------------------
    def add_sphere(self, center, radius: float, material: int, texture: int,
                   substance: int = SUBSTANCE_UNDEFINED) -> int:
        self._spheres.append((np.asarray(center, np.float32), float(radius),
                              material, texture, substance))
        return len(self._spheres) - 1

    def add_box(self, center, size, material: int, texture: int,
                substance: int = SUBSTANCE_UNDEFINED) -> int:
        """``size`` is the full edge length (scalar) or a per-axis 3-vector."""
        size = np.broadcast_to(np.asarray(size, np.float32), (3,))
        self._boxes.append((np.asarray(center, np.float32), size / 2.0,
                            material, texture, substance))
        return len(self._boxes) - 1

    def add_triangle(self, v0, v1, v2, material: int, texture: int,
                     substance: int = SUBSTANCE_UNDEFINED) -> int:
        self._tris.append((np.asarray(v0, np.float32),
                           np.asarray(v1, np.float32),
                           np.asarray(v2, np.float32),
                           material, texture, substance))
        return len(self._tris) - 1

    def add_mesh(self, vertices, faces, material: int, texture: int,
                 substance: int = SUBSTANCE_UNDEFINED) -> None:
        vertices = np.asarray(vertices, np.float32)
        for f in np.asarray(faces, np.int64):
            self.add_triangle(vertices[f[0]], vertices[f[1]], vertices[f[2]],
                              material, texture, substance)

    # -- build ---------------------------------------------------------------
    def build(self, device=None) -> Scene:
        if not self._tex_kind:
            self.add_solid_texture((0.0, 0.0, 0.0))
        if self._sky_tex is None:
            # reference default sky color is black (raytracer.ts:47-50)
            self._sky_tex = self.add_solid_texture((0.0, 0.0, 0.0))
        if not self._substances:
            self.add_substance(REFR_AIR)

        def stack(rows, shape):
            a = (np.stack(rows).astype(np.float32) if rows
                 else np.zeros(shape, np.float32))
            return a

        ids = ([s[2:] for s in self._spheres]
               + [b[2:] for b in self._boxes]
               + [t[3:] for t in self._tris])
        responses = [int(self._materials[i[0]][0]) for i in ids]
        mats = make_material_table(self._materials, device="cpu")
        # pad every image into a max-size atlas, keeping each native (h, w)
        if self._images:
            ah = max(im.shape[0] for im in self._images)
            aw = max(im.shape[1] for im in self._images)
            atlas = np.zeros((len(self._images), ah, aw, 3), np.float32)
            for k, im in enumerate(self._images):
                atlas[k, : im.shape[0], : im.shape[1]] = im
            img_h = np.array([im.shape[0] for im in self._images], np.int32)
            img_w = np.array([im.shape[1] for im in self._images], np.int32)
        else:
            ah, aw = self.atlas_hw or (1, 1)
            atlas = np.zeros((1, ah, aw, 3), np.float32)
            img_h = np.full(1, ah, np.int32)
            img_w = np.full(1, aw, np.int32)
        arrays = {
            "sphere_center": stack([s[0] for s in self._spheres], (0, 3)),
            "sphere_radius": stack([s[1] for s in self._spheres], (0,)),
            "box_center": stack([b[0] for b in self._boxes], (0, 3)),
            "box_half": stack([b[1] for b in self._boxes], (0, 3)),
            "tri_v0": stack([t[0] for t in self._tris], (0, 3)),
            "tri_v1": stack([t[1] for t in self._tris], (0, 3)),
            "tri_v2": stack([t[2] for t in self._tris], (0, 3)),
            "prim_material": np.array([i[0] for i in ids], np.int32),
            "prim_texture": np.array([i[1] for i in ids], np.int32),
            "prim_substance": np.array([i[2] for i in ids], np.int32),
            "materials.response": mats.response.numpy(),
            "materials.light": mats.light.numpy(),
            "materials.mirror": mats.mirror.numpy(),
            "materials.roughness": mats.roughness.numpy(),
            "textures.kind": np.array(self._tex_kind, np.int32),
            "textures.ref": np.array(self._tex_ref, np.int32),
            "textures.solid_rgb": np.stack(self._tex_solid),
            "textures.atlas": atlas,
            "textures.img_h": img_h,
            "textures.img_w": img_w,
            "sub_refr": np.array(self._substances, np.float32),
            "default_refr": np.float32(self._default_refr),
        }
        return scene_from_numpy(
            arrays, sky_tex=int(self._sky_tex), sky_box=self._sky_box,
            has_images=bool(self._images),
            has_bilinear=int(TextureKind.IMAGE_BILINEAR) in self._tex_kind,
            # BOTH rides the transmission machinery (substance query +
            # Snell/TIR), so it implies has_transmission
            has_transmission=any(r in (int(ResponseType.TRANSMISSION),
                                       int(ResponseType.BOTH))
                                 for r in responses),
            has_rough=any(float(self._materials[i[0]][3]) > 0.0 for i in ids),
            has_both=any(r == int(ResponseType.BOTH) for r in responses),
            device=device)

"""Texture resources (counterpart of ``zrenderer_tpu/engine/textures.py``):
host decode, mip pyramid, RGBA8 mip atlas, texture arrays.

Images decode on the host through ``utils/image.read_image`` (PNG, JPEG,
GIF, HDR, TIFF, DDS, ICO, BMP, TGA, PNM); the mip chain and the atlas are
built once at load on CPU tensors, and ``Renderer.set_environment``
uploads the atlas once to the renderer's device.  The lit pass samples
the atlas directly (``ops/sampling.py``); the reference's derived gather
atlases (quad, oct, pvar) are built lazily on the atlas's device, on
first use, for the samplers that read them.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from zrenderer_tpu_torch.ops.mipmap import generate_mip_chain, pack_mip_atlas
from zrenderer_tpu_torch.ops.sampling import (build_oct_atlas,
                                               build_pvar_atlas,
                                               build_quad_atlas,
                                               pack_texels_u32)
from zrenderer_tpu_torch.utils.image import read_image
from zrenderer_tpu_torch.utils.png import decode_png

log = logging.getLogger("zrenderer_torch.textures")


@dataclass
class Texture:
    atlas: torch.Tensor  # (h, 2w, 4) f32 mip atlas
    atlas_u32: torch.Tensor  # (h, 2w) RGBA8 as u32 bits in int32
    offsets: torch.Tensor  # (L,) i32 per-level x offsets
    sizes: torch.Tensor  # (L, 2) i32 per-level (h, w)
    num_levels: int
    base_shape: tuple
    # The derived gather atlases, built on first use (``_derived``).
    _quad: torch.Tensor | None = field(default=None, init=False, repr=False)
    _oct: torch.Tensor | None = field(default=None, init=False, repr=False)
    _pvar: torch.Tensor | None = field(default=None, init=False, repr=False)

    num_layers = 1

    def to(self, device) -> "Texture":
        """The sampler's atlas on ``device`` (the f32 atlas stays put; the
        derived atlases are built anew there on first use)."""
        return replace(self, atlas_u32=self.atlas_u32.to(device))

    def _derived(self, attr, builder):
        """The derived atlas ``attr``: ``builder`` run once per layer on
        ``atlas_u32``'s device, the layers stacked as ``atlas_u32``'s."""
        val = getattr(self, attr)
        if val is None:
            h, w = self.base_shape
            val = torch.cat([
                builder(self.atlas_u32[i * h:(i + 1) * h], h, w,
                        self.num_levels)
                for i in range(self.num_layers)])
            setattr(self, attr, val)
        return val

    @property
    def quad_atlas_u32(self):
        """(L*h, 2w, 4) RGBA8 2x2 neighbourhoods (one-row bilinear)."""
        return self._derived("_quad", build_quad_atlas)

    @property
    def oct_atlas_u32(self):
        """(L*h, 2w, 16) RGBA8: the quad and the parent 3x3."""
        return self._derived("_oct", build_oct_atlas)

    @property
    def pvar_atlas_u32(self):
        """(L*h, 2w, 32) RGBA8: the quad and the selected parent quad for
        each of the four anchor offsets."""
        return self._derived("_pvar", build_pvar_atlas)

    @classmethod
    def from_array(cls, image: np.ndarray, num_levels: int | None = None):
        """Create from an (h, w, 3|4) u8 or f32 host image."""
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / np.float32(255.0)
        img = img.astype(np.float32)
        if img.shape[2] == 3:
            img = np.concatenate(
                [img, np.ones((*img.shape[:2], 1), np.float32)], axis=-1)
        chain = generate_mip_chain(torch.from_numpy(img), num_levels)
        atlas, offsets, sizes = pack_mip_atlas(chain)
        return cls(atlas=atlas, atlas_u32=pack_texels_u32(atlas),
                   offsets=offsets, sizes=sizes, num_levels=len(chain),
                   base_shape=tuple(img.shape[:2]))

    @classmethod
    def from_png(cls, path, num_levels: int | None = None):
        """Decode a PNG file and create the texture (``from_image_file``
        takes every supported format)."""
        with open(path, "rb") as f:
            data = f.read()
        if data[:8] != b"\x89PNG\r\n\x1a\n":
            raise ValueError(f"{path}: not a PNG (from_image_file decodes "
                             "the other formats)")
        return cls.from_array(decode_png(data), num_levels)

    @classmethod
    def from_image_file(cls, path, num_levels: int | None = None):
        """Decode any supported image file (``utils/image.read_image``)
        and create the texture.  An HDR image arrives as f32 radiance;
        the mip chain filters it as it is and the RGBA8 packing clamps it
        to [0, 1], as in the reference."""
        return cls.from_array(read_image(path), num_levels)


@dataclass
class TextureArray:
    """Same-size textures stacked vertically into one atlas: layer i owns
    rows [i*h, (i+1)*h).  The sampler picks the layer per pixel (the
    G-buffer's texture-layer plane), so one gather serves every draw."""

    atlas_u32: torch.Tensor  # (L*h, 2w) RGBA8 as u32 bits in int32
    num_levels: int
    base_shape: tuple  # (h, w) of one layer
    num_layers: int
    _quad: torch.Tensor | None = field(default=None, init=False, repr=False)
    _oct: torch.Tensor | None = field(default=None, init=False, repr=False)
    _pvar: torch.Tensor | None = field(default=None, init=False, repr=False)

    to = Texture.to
    _derived = Texture._derived
    quad_atlas_u32 = Texture.quad_atlas_u32
    oct_atlas_u32 = Texture.oct_atlas_u32
    pvar_atlas_u32 = Texture.pvar_atlas_u32

    @classmethod
    def from_textures(cls, textures):
        """Stack Textures of one base size and mip count."""
        if not textures:
            raise ValueError("need at least one texture")
        base = textures[0]
        for t in textures:
            if (tuple(t.base_shape) != tuple(base.base_shape)
                    or t.num_levels != base.num_levels):
                raise ValueError(
                    "texture arrays need uniform layers: "
                    f"{t.base_shape}/{t.num_levels} != "
                    f"{base.base_shape}/{base.num_levels}")
        return cls(atlas_u32=torch.cat([t.atlas_u32 for t in textures]),
                   num_levels=base.num_levels,
                   base_shape=tuple(base.base_shape),
                   num_layers=len(textures))

    @classmethod
    def from_images(cls, images, num_levels: int | None = None):
        """Stack (h, w, 3|4) host images of one size."""
        return cls.from_textures(
            [Texture.from_array(img, num_levels) for img in images])


def checkerboard(size: int = 256, cells: int = 8, color_a=(1.0, 1.0, 1.0),
                 color_b=(0.25, 0.25, 0.3)) -> np.ndarray:
    """Procedural checker texture (test/demo content), (size, size, 4) f32."""
    ij = np.arange(size)
    cell = (ij[:, None] // (size // cells) + ij[None, :] // (size // cells)) % 2
    img = np.where(cell[..., None] > 0, np.array(color_a, np.float32),
                   np.array(color_b, np.float32))
    return np.concatenate([img, np.ones((size, size, 1), np.float32)],
                          axis=-1)


def white_texture() -> Texture:
    """1-texel white texture: the 'no texture bound' default."""
    return Texture.from_array(np.ones((1, 1, 4), np.float32), num_levels=1)


def textures_from_mesh_data(mesh_data, base_dir):
    """Load the meshes.bin TEXS table (uris relative to the scene folder).
    Returns (textures, material_textures) for Renderer.set_environment, or
    (None, None) when the scene has no textures, one fails to load (a
    missing file, an unsupported or corrupt image) or their sizes differ;
    the caller then binds its default texture."""
    uris = getattr(mesh_data, "texture_uris", None)
    if not uris:
        return None, None
    textures = []
    for uri in uris:
        path = os.path.join(base_dir, uri)
        try:
            textures.append(Texture.from_image_file(path))
        except (OSError, ValueError) as e:
            log.warning("texture %s failed to load (%s); falling back",
                        path, e)
            return None, None
    base = tuple(textures[0].base_shape)
    if any(tuple(t.base_shape) != base for t in textures):
        log.warning("scene textures have mixed sizes %s; texture arrays need "
                    "uniform layers - falling back",
                    [tuple(t.base_shape) for t in textures])
        return None, None
    return textures, list(mesh_data.material_texture)

"""Image presets (counterpart of ``optrace_tpu/presets/image.py``, numpy only).

All preset images are generated *procedurally*:

- standard charts (color checker from the published Macbeth sRGB values,
  grid, Siemens star, ETDRS-style tumbling-E chart, test cards) are
  synthesized exactly;
- the photographic scenes are deterministic synthetic scenes whose first-
  and second-order statistics are matched to measured statistics of
  photographs of such scenes: per-channel sRGB mean/std, inter-channel
  correlation matrix, radial power-spectrum slope (1/f^beta luminance
  spectrum) and vertical luminance gradient, plus scene-specific structure
  (paper rectangles, night point-lights, chart letters).

Every function takes (s, extent) and returns an RGBImage or GrayscaleImage.
"""

import numpy as np

from ..image import RGBImage, GrayscaleImage


def _rng(seed):
    return np.random.default_rng(seed)


# measured statistics of the reference photo assets (see module docstring):
# mean/std per sRGB channel, channel correlations (RG, RB, GB), luminance
# power-spectrum slope beta (P(k) ~ k^-beta), vertical luminance slope
_SCENE_STATS = {
    "cell": dict(mean=[0.397, 0.478, 0.483], std=[0.253, 0.21, 0.171],
                 corr=[0.598, 0.471, 0.976], beta=2.74, vgrad=-0.007),
    "documents": dict(mean=[0.631, 0.579, 0.536], std=[0.333, 0.378, 0.422],
                      corr=[0.958, 0.918, 0.988], beta=2.23, vgrad=-0.492),
    "fruits": dict(mean=[0.667, 0.512, 0.354], std=[0.264, 0.305, 0.304],
                   corr=[0.679, 0.536, 0.763], beta=3.01, vgrad=0.075),
    "group_photo": dict(mean=[0.403, 0.395, 0.388], std=[0.269, 0.26, 0.257],
                        corr=[0.962, 0.858, 0.944], beta=2.79, vgrad=0.044),
    "hong_kong": dict(mean=[0.333, 0.184, 0.187], std=[0.306, 0.258, 0.246],
                      corr=[0.697, 0.73, 0.883], beta=2.36, vgrad=0.291),
    "interior": dict(mean=[0.607, 0.597, 0.565], std=[0.297, 0.293, 0.297],
                     corr=[0.961, 0.901, 0.963], beta=2.54, vgrad=-0.420),
    "landscape": dict(mean=[0.458, 0.517, 0.577], std=[0.209, 0.193, 0.264],
                      corr=[0.867, 0.488, 0.811], beta=2.06, vgrad=-0.372),
    "eye_test_vintage": dict(mean=[0.224, 0.206, 0.205], std=[0.352, 0.338, 0.323],
                             corr=[0.982, 0.967, 0.991], beta=2.67, vgrad=0.209),
}


def _spectral_noise(r, n, beta):
    """Real 2D noise field with isotropic power spectrum P(k) ~ k^-beta,
    unit variance."""
    white = r.standard_normal((n, n))
    F = np.fft.fft2(white)
    ky = np.fft.fftfreq(n)[:, None]
    kx = np.fft.fftfreq(n)[None, :]
    k = np.hypot(ky, kx)
    k[0, 0] = 1.0
    F *= k ** (-beta / 2.0)
    F[0, 0] = 0.0
    f = np.real(np.fft.ifft2(F))
    return f / f.std()


def _match_moments(img, name, iters=3):
    """Affinely rescale per-channel deviations (then clip) until the
    image's mean/std match the measured reference statistics — used after
    scene-specific structure (rectangles, letters, lights) is drawn."""
    st = _SCENE_STATS[name]
    mean_t = np.asarray(st["mean"])
    std_t = np.asarray(st["std"])
    for _ in range(iters):
        m = img.mean((0, 1))
        sd = img.std((0, 1))
        img = np.clip(mean_t + (img - m) * (std_t / np.maximum(sd, 1e-6)), 0, 1)
    return img


def _stat_scene(seed, name, n=512):
    """Deterministic scene whose channel means/stds, inter-channel
    correlations, spectral slope and vertical gradient match the measured
    statistics of the reference photo asset ``name``."""
    st = _SCENE_STATS[name]
    r = _rng(seed)
    fields = np.stack([_spectral_noise(r, n, st["beta"]) for _ in range(3)], -1)

    c01, c02, c12 = st["corr"]
    C = np.array([[1.0, c01, c02], [c01, 1.0, c12], [c02, c12, 1.0]])
    # nearest-PD guard: clip tiny negative eigenvalues from measurement noise
    evals, evecs = np.linalg.eigh(C)
    L = evecs @ np.diag(np.sqrt(np.maximum(evals, 1e-6)))
    mixed = fields @ L.T
    mixed /= mixed.std((0, 1))

    yy = np.linspace(0.0, 1.0, n)[:, None, None]       # row 0 = image top
    img = st["mean"] + mixed * st["std"] + st["vgrad"] * (yy - 0.5)
    return np.clip(img, 0.0, 1.0)


# Scene images: procedural, statistics-matched to the reference assets ----

def cell(s=None, extent=None) -> RGBImage:
    """Synthetic microscopy-like scene. Stand-in for the reference's
    Stable-Diffusion cell image (reference presets/image.py:14-24);
    statistics-matched (see _SCENE_STATS['cell'])."""
    return RGBImage(_stat_scene(1, "cell"), s, extent, desc="Cell")


def documents(s=None, extent=None) -> RGBImage:
    """Synthetic desk-documents scene. Stand-in for the reference's desk
    photo (presets/image.py:26-36); statistics-matched plus bright paper
    rectangles."""
    img = _stat_scene(2, "documents")
    img[80:220, 60:240] = 0.7 * img[80:220, 60:240] + 0.3 * np.array([0.95, 0.95, 0.92])
    img[260:420, 200:460] = 0.7 * img[260:420, 200:460] + 0.3 * np.array([0.9, 0.9, 0.88])
    return RGBImage(_match_moments(img, "documents"), s, extent, desc="Documents")


def fruits(s=None, extent=None) -> RGBImage:
    """Synthetic fruits scene. Stand-in for the reference's fruit-tray
    photo (presets/image.py:38-48); statistics-matched (warm palette,
    steep spectrum from large smooth patches)."""
    return RGBImage(_stat_scene(3, "fruits"), s, extent, desc="Fruits")


def group_photo(s=None, extent=None) -> RGBImage:
    """Synthetic group-photo scene. Stand-in for the reference's group
    photo (presets/image.py:50-60); statistics-matched (near-neutral
    palette, strong channel correlation)."""
    return RGBImage(_stat_scene(4, "group_photo"), s, extent, desc="Group Photo")


def hong_kong(s=None, extent=None) -> RGBImage:
    """Synthetic city-night scene. Stand-in for the reference's Hong Kong
    street photo (presets/image.py:62-72); statistics-matched plus bright
    point lights."""
    img = _stat_scene(5, "hong_kong")
    r = _rng(6)
    ys, xs = r.integers(0, 512, 300), r.integers(0, 512, 300)
    img[ys, xs] = [1.0, 0.9, 0.6]
    return RGBImage(_match_moments(img, "hong_kong"), s, extent, desc="Hong Kong")


def interior(s=None, extent=None) -> RGBImage:
    """Synthetic interior scene. Stand-in for the reference's interior
    photo (presets/image.py:74-84); statistics-matched (bright warm
    neutrals, ceiling-lit vertical gradient)."""
    return RGBImage(_stat_scene(7, "interior"), s, extent, desc="Interior")


def landscape(s=None, extent=None) -> RGBImage:
    """Synthetic landscape scene. Stand-in for the reference's landscape
    photo (presets/image.py:86-96); statistics-matched (blue-heavy
    palette, shallow spectrum, bright-sky vertical gradient)."""
    return RGBImage(_stat_scene(8, "landscape"), s, extent, desc="Landscape")


def eye_test_vintage(s=None, extent=None) -> RGBImage:
    """Synthetic eye-test-chart scene: dark vintage background with
    bright Snellen-style letter rows, statistics-matched (the reference
    photo is a mostly-dark scene, mean~0.21, with a bright chart --
    presets/image.py:98-108)."""
    img = 0.3 * _stat_scene(9, "eye_test_vintage") + np.array([0.06, 0.05, 0.05])
    # bright chart frame (reproduces the reference's bimodal histogram:
    # mostly-dark surround + bright chart content)
    img[20:26, 20:492] = img[486:492, 20:492] = 0.9
    img[20:492, 20:26] = img[20:492, 486:492] = 0.9
    y = 440
    size = 60
    while size > 6 and y > 20:
        for x in range(40, 460, int(2.5 * size)):
            if x + size < 470:
                img[y - size:y, x:x + size // 4] = 0.92
                img[y - size:y - size + size // 4, x:x + size] = 0.92
                img[y - size // 2 - size // 8:y - size // 2 + size // 8, x:x + int(0.8 * size)] = 0.92
        y -= int(1.6 * size)
        size = int(size / 1.5)
    return RGBImage(_match_moments(img, "eye_test_vintage"), s, extent,
                    desc="Eye Test Vintage")


# Charts (exact procedural generation) ---------------------------------

def color_checker(s=None, extent=None) -> RGBImage:
    """Macbeth/X-Rite ColorChecker chart from the published sRGB patch
    values (classic 24-patch chart)."""
    # published sRGB coordinates of the 24 patches (row-major, top-left first)
    patches = np.array([
        [115, 82, 68], [194, 150, 130], [98, 122, 157], [87, 108, 67], [133, 128, 177], [103, 189, 170],
        [214, 126, 44], [80, 91, 166], [193, 90, 99], [94, 60, 108], [157, 188, 64], [224, 163, 46],
        [56, 61, 150], [70, 148, 73], [175, 54, 60], [231, 199, 31], [187, 86, 149], [8, 133, 161],
        [243, 243, 242], [200, 200, 200], [160, 160, 160], [122, 122, 121], [85, 85, 85], [52, 52, 52],
    ], dtype=np.float64) / 255.0

    ph, pw, border = 80, 80, 8
    H = 4 * ph + 5 * border
    W = 6 * pw + 7 * border
    img = np.zeros((H, W, 3))
    for i in range(4):
        for j in range(6):
            y0 = border + i * (ph + border)
            x0 = border + j * (pw + border)
            img[y0:y0 + ph, x0:x0 + pw] = patches[i * 6 + j]
    img = np.flipud(img)   # element [0,0] = lower-left convention
    return RGBImage(img, s, extent, desc="Color Checker Chart")


def ETDRS_chart(s=None, extent=None) -> GrayscaleImage:
    """ETDRS-style tumbling-E acuity chart (procedural)."""
    img = np.ones((512, 512))
    r = _rng(10)
    y = 30
    size = 80
    while size >= 8 and y + size < 500:
        n_let = min(5, 460 // int(2 * size))
        for k in range(n_let):
            x = 26 + k * int(2 * size)
            rot = r.integers(0, 4)
            E = np.zeros((5, 5))
            E[:, 0] = 1
            E[0, :] = E[2, :] = E[4, :] = 1
            E = np.rot90(E, rot)
            Eimg = np.kron(E, np.ones((size // 5, size // 5)))
            h, w = Eimg.shape
            img[y:y + h, x:x + w] = 1 - Eimg
        y += int(1.8 * size)
        size = int(size / 1.26)
    return GrayscaleImage(np.flipud(img), s, extent, desc="ETDRS Chart")


def ETDRS_chart_inverted(s=None, extent=None) -> GrayscaleImage:
    """Inverted (white-on-black) ETDRS-style chart. Grayscale like the
    reference (presets/image.py:119-129 converts to_grayscale_image)."""
    g = ETDRS_chart(s if s is not None else [1, 1], extent)
    return GrayscaleImage(1.0 - g.data, s, extent, desc="ETDRS Chart Inverted")


def grid(s=None, extent=None) -> GrayscaleImage:
    """White grid on black background, 10×10 cells (distortion testing,
    reference presets/image.py:142-155)."""
    sz = 501
    img = np.zeros((sz, sz))
    for p in np.linspace(0, sz - 1, 11).astype(int):
        img[p, :] = 1.0
        img[:, p] = 1.0
    return GrayscaleImage(img, s, extent, desc="Grid")


def siemens_star(s=None, extent=None) -> GrayscaleImage:
    """Siemens star with 36 spokes (resolution testing)."""
    sz = 601
    Y, X = np.mgrid[-1:1:sz * 1j, -1:1:sz * 1j]
    phi = np.arctan2(Y, X)
    R = np.hypot(X, Y)
    img = (np.sin(36 * phi) > 0).astype(np.float64)
    img[R > 0.95] = 1.0
    img[R < 0.03] = 1.0
    return GrayscaleImage(img, s, extent, desc="Siemens Star")


def tv_testcard1(s=None, extent=None) -> RGBImage:
    """SMPTE-style color-bars test card (procedural)."""
    H, W = 480, 640
    img = np.zeros((H, W, 3))
    bars = np.array([[1, 1, 1], [1, 1, 0], [0, 1, 1], [0, 1, 0],
                     [1, 0, 1], [1, 0, 0], [0, 0, 1]], dtype=np.float64) * 0.75
    bw = W // 7
    for i, c in enumerate(bars):
        img[H // 3:, i * bw:(i + 1) * bw] = c
    # bottom gradient + castellation
    ramp = np.linspace(0, 1, W)
    img[:H // 3] = ramp[None, :, None]
    return RGBImage(np.clip(np.flipud(img), 0, 1), s, extent, desc="TV Testcard 1")


def tv_testcard2(s=None, extent=None) -> RGBImage:
    """Geometry test card: grid + circle + color patches (procedural)."""
    H = W = 512
    img = np.full((H, W, 3), 0.5)
    for p in range(0, W, 32):
        img[p:p + 1, :] = 1.0
        img[:, p:p + 1] = 1.0
    Y, X = np.mgrid[-1:1:H * 1j, -1:1:W * 1j]
    ring = np.abs(np.hypot(X, Y) - 0.8) < 0.01
    img[ring] = [1, 1, 1]
    img[200:240, 100:180] = [1, 0, 0]
    img[200:240, 220:300] = [0, 1, 0]
    img[200:240, 340:420] = [0, 0, 1]
    return RGBImage(np.clip(img, 0, 1), s, extent, desc="TV Testcard 2")


scenes: list = [cell, documents, fruits, group_photo, hong_kong, interior, landscape]
charts: list = [color_checker, ETDRS_chart, ETDRS_chart_inverted, eye_test_vintage,
                grid, siemens_star, tv_testcard1, tv_testcard2]
all_presets: list = [*scenes, *charts]

"""3D scene rendering for the GUI (counterpart of
``optrace_tpu/gui/scene_plotting.py``; reference
optrace/gui/_scene_plotting.py).

Renders the raytracer geometry and traced rays into a matplotlib 3D axes:
lens/detector/aperture/filter surface meshes from Surface.plotting_mesh,
element side cylinders, the outline box, markers, volumes and a random
subset of ray polylines colored by the selected mode. Ray picking returns
the reference's info-text content for a ray section.

The rays come from ``RT.rays`` (``RayStorage``), whose sections stay on
the raytracer's device: a replot reads the shown subset through
``rays_by_mask``, which copies those rays alone to the host.
"""

import numpy as np
import matplotlib
import matplotlib.pyplot as plt
from mpl_toolkits.mplot3d.art3d import Line3DCollection

from ..geometry import Lens, IdealLens, Filter, Aperture, Detector, RaySource
from ..geometry.marker import PointMarker, LineMarker
from ..geometry.point import Point
from ..geometry.line import Line
from .. import color as ocolor


class ScenePlotting:

    MAX_RAYS_SHOWN: int = 10000
    SURFACE_RES: int = 30

    coloring_modes: list = ['Plain', 'Power', 'Wavelength', 'Source',
                            'Polarization xz', 'Polarization yz', 'Refractive Index']

    def __init__(self, gui, raytracer, initial_camera: dict = None) -> None:
        self.gui = gui
        self.raytracer = raytracer
        self.fig = None
        self.ax = None
        self._ray_artist = None
        self._pick_artist = None
        self._crosshair_artists = []
        self._crosshair_pos = None
        self._initial_camera = initial_camera or {}
        self._ray_selection = np.array([], dtype=bool)
        # properties of the currently shown rays (property browser tab,
        # reference _scene_plotting.py:83-84 and the ray legend keys)
        self._ray_property_dict = {}
        self._set_colors()

    # ------------------------------------------------------------------
    def _set_colors(self) -> None:
        """Color scheme; switches with high_contrast like the reference
        (_scene_plotting.py:659-680)."""
        hc = bool(getattr(self.gui, "high_contrast", False))
        self._background_color = (1.0, 1.0, 1.0) if hc else (0.2, 0.2, 0.2)
        self._foreground_color = (0.0, 0.0, 0.0) if hc else (1.0, 1.0, 1.0)
        self._lens_color = self._foreground_color if hc else (0.63, 0.79, 1.00)
        self._detector_color = self._foreground_color if hc else (0.8, 0.8, 0.2)
        self._aperture_color = self._foreground_color if hc else (0.13, 0.13, 0.13)
        self._source_color = self._foreground_color if hc else (0.8, 0.2, 0.2)
        self._subtle_color = (0.7, 0.7, 0.7) if hc else (0.3, 0.3, 0.3)
        self._marker_color = self._foreground_color if hc else (0.0, 0.6, 0.0)
        self._outline_color = self._subtle_color
        self._crosshair_color = (1.0, 0.0, 0.0)
        self._plain_ray_color = (0.0, 0.0, 0.0) if hc else (0.8, 0.8, 0.8)

    # ------------------------------------------------------------------
    def init_scene(self) -> None:
        if self.fig is None:
            self.fig = plt.figure(figsize=(11, 7))
            # scene occupies the left part; the right strip is reserved for
            # the rendered widget side panel (interactors.SidePanel)
            self.ax = self.fig.add_subplot(111, projection="3d")
            self.fig.subplots_adjust(left=0.0, right=0.72)
            self._pick_text_artist = self.fig.text(
                0.01, 0.01, "", fontsize=7, family="monospace",
                verticalalignment="bottom")
        self.ax.set_xlabel("x in mm")
        self.ax.set_ylabel("y in mm")
        self.ax.set_zlabel("z in mm")
        if self._initial_camera:
            self.gui.set_camera(**self._initial_camera)

    # ------------------------------------------------------------------
    def plot_outline(self) -> None:
        o = self.raytracer.outline
        # 12 box edges
        xs, xe, ys, ye, zs, ze = o
        for (a, b) in [((xs, ys, zs), (xe, ys, zs)), ((xs, ye, zs), (xe, ye, zs)),
                       ((xs, ys, ze), (xe, ys, ze)), ((xs, ye, ze), (xe, ye, ze)),
                       ((xs, ys, zs), (xs, ye, zs)), ((xe, ys, zs), (xe, ye, zs)),
                       ((xs, ys, ze), (xs, ye, ze)), ((xe, ys, ze), (xe, ye, ze)),
                       ((xs, ys, zs), (xs, ys, ze)), ((xe, ys, zs), (xe, ys, ze)),
                       ((xs, ye, zs), (xs, ye, ze)), ((xe, ye, zs), (xe, ye, ze))]:
            self.ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                         color="gray", lw=0.5, alpha=0.5)

    def _plot_surface_mesh(self, surf, color, alpha=0.6) -> None:
        if isinstance(surf, (Point, Line)):
            if isinstance(surf, Point):
                self.ax.scatter([surf.pos[0]], [surf.pos[1]], [surf.pos[2]], color=color)
            else:
                e = surf.extent
                self.ax.plot([e[0], e[1]], [e[2], e[3]], [surf.pos[2]] * 2, color=color)
            return
        try:
            X, Y, Z = surf.plotting_mesh(self.SURFACE_RES)
            Zm = np.ma.masked_invalid(Z)
            self.ax.plot_surface(X, Y, Zm, color=color, alpha=alpha,
                                 linewidth=0, antialiased=False)
        except Exception:
            xe, ye, ze = surf.edge(50)
            self.ax.plot(xe, ye, ze, color=color)

    def _plot_cylinder(self, el, color, alpha=0.35) -> None:
        """Element side wall between front and back edges (reference
        Element.cylinder_surface mesh, _scene_plotting.py plot_element)."""
        try:
            X, Y, Z = el.cylinder_surface(self.SURFACE_RES * 2)
            self.ax.plot_surface(X, Y, np.ma.masked_invalid(Z), color=color,
                                 alpha=alpha, linewidth=0, antialiased=False)
        except Exception:
            pass

    def plot_elements(self) -> None:
        minimalistic = bool(self.gui.minimalistic_view)
        for el in self.raytracer.elements:
            cylinder = False
            if isinstance(el, (Lens, IdealLens)):
                c = self._lens_color
                cylinder = not isinstance(el, IdealLens)
            elif isinstance(el, Aperture):
                c = self._aperture_color
            elif isinstance(el, Filter):
                fc = el.color()
                c = self._foreground_color if self.gui.high_contrast else fc[:3]
                cylinder = el.has_back()
            elif isinstance(el, Detector):
                c = self._detector_color
            elif isinstance(el, RaySource):
                c = self._source_color
            elif isinstance(el, (PointMarker, LineMarker)):
                self._plot_marker(el)
                continue
            else:   # volumes
                c = el.color[:3] if getattr(el, "color", None) is not None \
                    and not self.gui.high_contrast else self._subtle_color
                self._plot_surface_mesh(el.front, c, alpha=getattr(el, "opacity", 0.2))
                if el.has_back():
                    self._plot_surface_mesh(el.back, c, alpha=getattr(el, "opacity", 0.2))
                    self._plot_cylinder(el, c, alpha=getattr(el, "opacity", 0.2))
                continue

            self._plot_surface_mesh(el.front, c)
            if el.has_back():
                self._plot_surface_mesh(el.back, c)
                if cylinder:
                    self._plot_cylinder(el, c)
            if not self.gui.hide_labels and not minimalistic:
                pos = el.pos
                self.ax.text(pos[0], pos[1], pos[2], el.get_desc(), fontsize=7,
                             color=self._foreground_color if self.gui.high_contrast else None,
                             rotation=90 if self.gui.vertical_labels else 0)

    def plot_index_boxes(self) -> None:
        """Wireframe outlines + labels for ambient refraction-index regions
        between lenses (reference _scene_plotting.py:359-420)."""
        from ..spectrum.refraction_index import RefractionIndex

        RT = self.raytracer
        lenses = sorted(RT.lenses, key=lambda el: el.pos[2])
        n_list = [RT.n0] + [el.n2 for el in lenses] + [RT.n0]
        bounds = [(RT.outline[4], RT.outline[4])] + \
                 [(np.mean(el.front.extent[4:]), np.mean(el.back.extent[4:]))
                  for el in lenses] + \
                 [(RT.outline[5], RT.outline[5])]
        n_list = [RT.n0 if ni is None else ni for ni in n_list]

        # drop zero-extent boxes, join neighbors with the same medium
        i = 0
        while i < len(n_list) - 2:
            if bounds[i + 1][0] - bounds[i][1] < 5e-4:
                del n_list[i], bounds[i]
            else:
                i += 1
        i = 0
        while i < len(n_list) - 2:
            if n_list[i] == n_list[i + 1]:
                del n_list[i + 1], bounds[i + 1]
            else:
                i += 1

        if len(bounds) == 2 and n_list[0] == RefractionIndex("Constant", n=1.0):
            return    # vacuum everywhere: nothing to annotate

        xs, xe, ys, ye = RT.outline[:4]
        for i in range(len(bounds) - 1):
            z0, z1 = bounds[i][1], bounds[i + 1][0]
            for (a, b) in [((xs, ys, z0), (xe, ys, z0)), ((xs, ye, z0), (xe, ye, z0)),
                           ((xs, ys, z1), (xe, ys, z1)), ((xs, ye, z1), (xe, ye, z1)),
                           ((xs, ys, z0), (xs, ys, z1)), ((xe, ys, z0), (xe, ys, z1)),
                           ((xs, ye, z0), (xs, ye, z1)), ((xe, ye, z0), (xe, ye, z1))]:
                self.ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                             color=self._outline_color, lw=0.8, alpha=0.7,
                             linestyle="--")
            if not self.gui.hide_labels:
                label = ("" if self.gui.minimalistic_view else "ambient\n") \
                    + "n=" + n_list[i].get_desc()
                self.ax.text(np.mean([xs, xe]), ys + (ye - ys) * 0.05,
                             np.mean([z0, z1]), label, fontsize=6,
                             color=self._foreground_color if self.gui.high_contrast else None)

    def _plot_marker(self, m) -> None:
        if isinstance(m, PointMarker):
            if not m.label_only:
                self.ax.scatter([m.pos[0]], [m.pos[1]], [m.pos[2]],
                                color="w" if self.gui.high_contrast else "k",
                                s=20 * m.marker_factor)
            if not self.gui.hide_labels:
                self.ax.text(m.pos[0], m.pos[1], m.pos[2], m.get_desc(),
                             fontsize=7 * m.text_factor)
        else:
            e = m.front.extent
            self.ax.plot([e[0], e[1]], [e[2], e[3]], [m.pos[2]] * 2,
                         lw=m.line_factor, color="gray")
            if not self.gui.hide_labels:
                self.ax.text(m.pos[0], m.pos[1], m.pos[2], m.get_desc(),
                             fontsize=7 * m.text_factor)

    def plot_fault_markers(self) -> None:
        fp = self.raytracer.fault_pos
        if len(fp):
            self.ax.scatter(fp[:, 0], fp[:, 1], fp[:, 2], color="red", marker="x", s=40)

    # ------------------------------------------------------------------
    def _ray_colors(self, mode, wl, w, snum, pol, n):
        """per-ray RGB colors according to the coloring mode
        (reference _scene_plotting.py:966-1084), from the shown rays'
        wavelengths, source numbers and first sections' power, polarization
        and refractive index."""
        N_sel = wl.shape[0]
        if mode == "Plain":
            return np.tile([list(self._plain_ray_color)], (N_sel, 1))
        if mode == "Wavelength":
            rgba = np.asarray(ocolor.spectral_colormap(wl))
            return rgba[:, :3]
        if mode == "Power":
            t = w / max(w.max(), 1e-30)
            cmap = matplotlib.colormaps["viridis"]
            return cmap(t)[:, :3]
        if mode == "Source":
            cmap = matplotlib.colormaps["tab10"]
            return cmap(snum % 10)[:, :3]
        if mode in ("Polarization xz", "Polarization yz"):
            comp = 0 if mode == "Polarization xz" else 1
            t = np.abs(pol[:, comp])
            t = np.nan_to_num(t)
            cmap = matplotlib.colormaps["coolwarm"]
            return cmap(t)[:, :3]
        if mode == "Refractive Index":
            rng = n.max() - n.min()
            t = (n - n.min()) / rng if rng else np.zeros_like(n)
            cmap = matplotlib.colormaps["plasma"]
            return cmap(t)[:, :3]
        return np.tile([[0.8, 0.8, 0.8]], (N_sel, 1))

    def plot_rays(self, mask: np.ndarray = None, max_show: int = None) -> None:
        rays = self.raytracer.rays
        if not rays.N:
            return
        max_show = max_show if max_show is not None else self.gui.rays_visible
        max_show = min(max_show, self.MAX_RAYS_SHOWN)

        rng = np.random.default_rng(0)
        base = np.ones(rays.N, dtype=bool) if mask is None else mask.copy()
        idx = np.where(base)[0]
        if idx.shape[0] > max_show:
            idx = rng.choice(idx, size=max_show, replace=False)
        sel = np.zeros(rays.N, dtype=bool)
        sel[idx] = True
        self._ray_selection = sel

        # property-browser tab of the shown rays (reference legend keys,
        # property_browser.py:22-28): only the shown rays leave the device
        pr, s, pol, w, wl, snum, n = rays.rays_by_mask(sel)
        p = segments = pr             # (n, nt, 3)
        colors = self._ray_colors(self.gui.coloring_mode, wl, w[:, 0], snum, pol[:, 0], n[:, 0])

        s_un = p[:, 1:] - p[:, :-1]
        s_un = np.concatenate((s_un, np.zeros((s_un.shape[0], 1, 3))), axis=1)
        self._ray_property_dict = dict(
            p=pr, s=s, s_un=s_un, pol=pol, w=w, wv=wl, snum=snum, n=n,
            index=np.where(sel)[0],
            l=rays.ray_lengths(sel), ol=rays.optical_lengths(sel))

        if self._ray_artist is not None:
            try:
                self._ray_artist.remove()
            except Exception:
                pass
        lc = Line3DCollection(segments, colors=colors,
                              linewidths=self.gui.ray_width,
                              alpha=float(np.clip(self.gui.ray_opacity, 1e-5, 1.0)))
        self.ax.add_collection3d(lc)
        self._ray_artist = lc

    # ------------------------------------------------------------------
    def ray_info_text(self, index: int, section: int = 0) -> str:
        """info text of one ray section (reference picking text)."""
        rays = self.raytracer.rays
        p, s, pol, w, wl, snum, n = rays.rays_by_mask(
            np.arange(rays.N) == index, None, ret=[1, 1, 1, 1, 1, 1, 1])
        sec = min(section, rays.Nt - 1)
        txt = (f"Ray {index} from Source RS{snum[0]}\n"
               f"Section {sec}\n"
               f"position: ({p[0, sec, 0]:.5g} mm, {p[0, sec, 1]:.5g} mm, {p[0, sec, 2]:.5g} mm)\n"
               f"direction: ({s[0, sec, 0]:.5f}, {s[0, sec, 1]:.5f}, {s[0, sec, 2]:.5f})\n"
               f"wavelength: {wl[0]:.2f} nm\n"
               f"power: {w[0, sec]:.3e} W\n"
               f"refractive index: {n[0, sec]:.5f}")
        return txt

    def highlight_ray(self, index: int, section: int = None) -> None:
        rays = self.raytracer.rays
        p = rays.rays_by_mask(np.arange(rays.N) == index, ret=[1, 0, 0, 0, 0, 0, 0])[0][0]
        if self._pick_artist is not None:
            try:
                self._pick_artist.remove()
            except Exception:
                pass
        if section is None:
            self._pick_artist, = self.ax.plot(p[:, 0], p[:, 1], p[:, 2],
                                              color="red", lw=2.5)
        else:
            self._pick_artist = self.ax.scatter([p[section, 0]], [p[section, 1]],
                                                [p[section, 2]], color="red", s=60)

    def plot_crosshair(self, pos) -> None:
        """Red axis-aligned crosshair through a 3D point (reference
        space-picking crosshair, _scene_plotting.py:1248-1364)."""
        self.clear_crosshair()
        o = self.raytracer.outline
        x, y, z = float(pos[0]), float(pos[1]), float(pos[2])
        arts = [self.ax.plot([o[0], o[1]], [y, y], [z, z],
                             color=self._crosshair_color, lw=1.0)[0],
                self.ax.plot([x, x], [o[2], o[3]], [z, z],
                             color=self._crosshair_color, lw=1.0)[0],
                self.ax.plot([x, x], [y, y], [o[4], o[5]],
                             color=self._crosshair_color, lw=1.0)[0]]
        self._crosshair_artists = arts
        self._crosshair_pos = (x, y, z)

    def clear_crosshair(self) -> None:
        for a in self._crosshair_artists:
            try:
                a.remove()
            except Exception:
                pass
        self._crosshair_artists = []
        self._crosshair_pos = None

    def pick_nearest_section(self, pos):
        """Nearest displayed ray section to a 3D point: the programmatic
        form of the reference's click picking. Returns (ray_index,
        section_index) or None when no rays are shown."""
        rays = self.raytracer.rays
        if not rays.N or not np.any(self._ray_selection):
            return None
        idx = np.where(self._ray_selection)[0]
        p = rays.rays_by_mask(self._ray_selection, ret=[1, 0, 0, 0, 0, 0, 0])[0]     # (n, nt, 3)
        d2 = np.sum((p - np.asarray(pos, dtype=np.float64)) ** 2, axis=-1)
        flat = int(np.argmin(d2))
        return int(idx[flat // p.shape[1]]), int(flat % p.shape[1])

    def set_pick_text(self, txt: str) -> None:
        """Show pick info in the scene corner (reference pick text overlay,
        _scene_plotting.py:1248-1364)."""
        if getattr(self, "_pick_text_artist", None) is not None:
            self._pick_text_artist.set_text(txt)

    def clear_picking(self) -> None:
        self.clear_crosshair()
        if self._pick_artist is not None:
            try:
                self._pick_artist.remove()
            except Exception:
                pass
            self._pick_artist = None

    # ------------------------------------------------------------------
    def replot(self) -> None:
        assert self.ax is not None, "init_scene() first"
        self.ax.clear()
        self._ray_artist = None
        self._pick_artist = None
        self._crosshair_artists = []
        self._set_colors()
        self.ax.set_xlabel("x in mm")
        self.ax.set_ylabel("y in mm")
        self.ax.set_zlabel("z in mm")
        self.ax.set_facecolor("white" if self.gui.high_contrast else "#333333")
        self.plot_outline()
        self.plot_elements()
        if not self.gui.minimalistic_view:
            self.plot_index_boxes()
        self.plot_fault_markers()
        self.plot_rays()
        o = self.raytracer.outline
        self.ax.set_xlim(o[0], o[1])
        self.ax.set_ylim(o[2], o[3])
        self.ax.set_zlim(o[4], o[5])

"""Fraunhofer spectral line wavelengths (nm) and Abbe-number combinations.

Standard physical constants (see e.g. the Abbe-number literature); parity
with reference ``optrace/tracer/presets/spectral_lines.py:7-41``.
"""

h: float = 404.6561    #: Hg, violet
g: float = 435.8343    #: Hg, blue
F_: float = 479.9914   #: F' Cd, blue
F: float = 486.1327    #: H, blue
e: float = 546.0740    #: Hg, green
d: float = 587.5618    #: He, yellow
D: float = 589.2938    #: Na, yellow
C_: float = 643.8469   #: C' Cd, red
C: float = 656.272     #: H, red
r: float = 706.5188    #: He, red
A_: float = 768.2      #: A' K, IR-A

all_lines: list = [h, g, F_, F, e, d, D, C_, C, r, A_]
"""all line presets, ordered by wavelength"""

FDC: list = [F, D, C]
FdC: list = [F, d, C]
FeC: list = [F, e, C]
F_eC_: list = [F_, e, C_]

rgb: list = [464.3118, 549.1321, 611.2826]
"""dominant wavelengths of the sRGB primaries (order b, g, r)"""

all_line_combinations: list = [FDC, FdC, FeC, F_eC_, rgb]

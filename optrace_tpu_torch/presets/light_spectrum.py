"""Light spectrum presets: standard illuminants and line combinations
(counterpart of ``optrace_tpu/presets/light_spectrum.py``; the sRGB
primaries arrive with the colour-conversion slice)."""

from . import spectral_lines as Lines
from ..spectrum.light_spectrum import LightSpectrum
from .. import color

# Standard illuminants -------------------------------------------------

a = LightSpectrum("Function", func=color.a_illuminant, desc="A", long_desc="Illuminant A")
c = LightSpectrum("Function", func=color.c_illuminant, desc="C", long_desc="Illuminant C")
d50 = LightSpectrum("Function", func=color.d50_illuminant, desc="D50", long_desc="Illuminant D50")
d55 = LightSpectrum("Function", func=color.d55_illuminant, desc="D55", long_desc="Illuminant D55")
d65 = LightSpectrum("Function", func=color.d65_illuminant, desc="D65", long_desc="Illuminant D65")
d75 = LightSpectrum("Function", func=color.d75_illuminant, desc="D75", long_desc="Illuminant D75")
e = LightSpectrum("Function", func=color.e_illuminant, desc="E", long_desc="Illuminant E")
f2 = LightSpectrum("Function", func=color.f2_illuminant, desc="F2", long_desc="Illuminant F2")
f7 = LightSpectrum("Function", func=color.f7_illuminant, desc="F7", long_desc="Illuminant F7")
f11 = LightSpectrum("Function", func=color.f11_illuminant, desc="F11", long_desc="Illuminant F11")
led_b1 = LightSpectrum("Function", func=color.led_b1_illuminant, desc="LED-B1", long_desc="Illuminant LED-B1")
led_b2 = LightSpectrum("Function", func=color.led_b2_illuminant, desc="LED-B2", long_desc="Illuminant LED-B2")
led_b3 = LightSpectrum("Function", func=color.led_b3_illuminant, desc="LED-B3", long_desc="Illuminant LED-B3")
led_b4 = LightSpectrum("Function", func=color.led_b4_illuminant, desc="LED-B4", long_desc="Illuminant LED-B4")
led_b5 = LightSpectrum("Function", func=color.led_b5_illuminant, desc="LED-B5", long_desc="Illuminant LED-B5")
led_bh1 = LightSpectrum("Function", func=color.led_bh1_illuminant, desc="LED-BH1", long_desc="Illuminant LED-BH1")
led_rgb1 = LightSpectrum("Function", func=color.led_rgb1_illuminant, desc="LED-RGB1", long_desc="Illuminant LED-RGB1")
led_v1 = LightSpectrum("Function", func=color.led_v1_illuminant, desc="LED-V1", long_desc="Illuminant LED-V1")
led_v2 = LightSpectrum("Function", func=color.led_v2_illuminant, desc="LED-V2", long_desc="Illuminant LED-V2")

standard_natural: list = [a, c, d50, d55, d65, d75, e]
standard_f: list = [f2, f7, f11]
standard_led: list = [led_b1, led_b2, led_b3, led_b4, led_b5, led_bh1, led_rgb1, led_v1, led_v2]
standard: list = [*standard_natural, *standard_f, *standard_led]

# spectral line combinations -------------------------------------------

FDC = LightSpectrum("Lines", lines=Lines.FDC, line_vals=[1, 1, 1],
                    desc="Lines FDC", long_desc="Spectral Lines F, D, C")
FdC = LightSpectrum("Lines", lines=Lines.FdC, line_vals=[1, 1, 1],
                    desc="Lines FdC", long_desc="Spectral Lines F, d, C")
FeC = LightSpectrum("Lines", lines=Lines.FeC, line_vals=[1, 1, 1],
                    desc="Lines Fec", long_desc="Spectral Lines F, e, C")
F_eC_ = LightSpectrum("Lines", lines=Lines.F_eC_, line_vals=[1, 1, 1],
                      desc="Lines F'eC'", long_desc="Spectral Lines F', e, C'")
rgb_lines = LightSpectrum("Lines", lines=Lines.rgb, line_vals=[0.5745000, 0.5985758, 0.3895581],
                          desc="RGB Lines'", long_desc="sRGB Primary Dominant Wavelengths")

lines: list = [FDC, FdC, FeC, F_eC_, rgb_lines]

all_presets: list = [*standard, *lines]

"""Material presets: glasses, plastics, misc media.

All coefficients are published catalog/vendor data (SCHOTT datasheets,
refractiveindex.info); parity with reference
``optrace/tracer/presets/refraction_index.py``.
"""

import numpy as np

from ..spectrum.refraction_index import RefractionIndex

# glasses (SCHOTT Sellmeier data) --------------------------------------

BAF10 = RefractionIndex("Sellmeier1", coeff=[1.5851495, 0.00926681282, 0.143559385,
                                             0.0424489805, 1.08521269, 105.613573],
                        desc="BAF10", long_desc="N_BAF10 (SCHOTT)")
BAK1 = RefractionIndex("Sellmeier1", coeff=[1.12365662, 0.00644742752, 0.309276848,
                                            0.0222284402, 0.881511957, 107.297751],
                       desc="BAK1", long_desc="N-BAK1 (SCHOTT)")
BASF64 = RefractionIndex("Sellmeier1", coeff=[1.65554268, 0.0104485644, 0.17131977,
                                              0.0499394756, 1.33664448, 118.961472],
                         desc="BASF64", long_desc="N-BASF64 (SCHOTT)")
BK7 = RefractionIndex("Sellmeier1", coeff=[1.03961212, 0.00600069867, 0.231792344,
                                           0.0200179144, 1.01046945, 103.560653],
                      desc="BK7", long_desc="N-BK7 (SCHOTT)")
F2 = RefractionIndex("Sellmeier1", coeff=[1.39757037, 0.00995906143, 0.159201403,
                                          0.0546931752, 1.2686543, 119.248346],
                     desc="F2", long_desc="N-F2 (SCHOTT)")
FK51A = RefractionIndex("Sellmeier1", coeff=[0.971247817, 0.00472301995, 0.216901417,
                                             0.0153575612, 0.904651666, 168.68133],
                        desc="FK51A", long_desc="N-FK51A (SCHOTT)")
fused_silica = RefractionIndex("Sellmeier1", coeff=[0.6961663, 0.0684043 ** 2, 0.4079426,
                                                    0.1162414 ** 2, 0.8974794, 9.896161 ** 2],
                               desc="Fused_Silica", long_desc="Fused silica (fused quartz)")
K5 = RefractionIndex("Sellmeier1", coeff=[1.08511833, 0.00661099503, 0.199562005,
                                          0.024110866, 0.930511663, 111.982777],
                     desc="K5", long_desc="N-K5 (SCHOTT)")
LAF2 = RefractionIndex("Sellmeier1", coeff=[1.80984227, 0.0101711622, 0.15729555,
                                            0.0442431765, 1.0930037, 100.687748],
                       desc="LAF2", long_desc="N-LAF2 (SCHOTT)")
LAK8 = RefractionIndex("Sellmeier1", coeff=[1.33183167, 0.00620023871, 0.546623206,
                                            0.0216465439, 1.19084015, 82.5827736],
                       desc="LAK8", long_desc="N-LAK8 (SCHOTT)")
LAK22 = RefractionIndex("Sellmeier1", coeff=[1.14229781, 0.00585778594, 0.535138441,
                                             0.0198546147, 1.04088385, 100.834017],
                        desc="LAK22", long_desc="N-LAK22 (SCHOTT)")
LASF9 = RefractionIndex("Sellmeier1", coeff=[2.00029547, 0.0121426017, 0.298926886,
                                             0.0538736236, 1.80691843, 156.530829],
                        desc="LASF9", long_desc="N-LASF9 (SCHOTT)")
LASF44 = RefractionIndex("Sellmeier1", coeff=[1.78897105, 0.00872506277, 0.38675867,
                                              0.0308085023, 1.30506243, 92.7743824],
                         desc="LASF44", long_desc="N-LASF44 (SCHOTT)")
LF5 = RefractionIndex("Sellmeier1", coeff=[1.28035628, 0.00929854416, 0.163505973,
                                           0.0449135769, 0.893930112, 110.493685],
                      desc="LF5", long_desc="N-LF5 (SCHOTT)")
SF5 = RefractionIndex("Sellmeier1", coeff=[1.52481889, 0.011254756, 0.187085527,
                                           0.0588995392, 1.42729015, 129.141675],
                      desc="SF5", long_desc="N-SF5 (SCHOTT)")
SF6 = RefractionIndex("Sellmeier1", coeff=[1.72448482, 0.0134871947, 0.390104889,
                                           0.0569318095, 1.04572858, 118.557185],
                      desc="SF6", long_desc="N-SF6 (SCHOTT)")
SF10 = RefractionIndex("Sellmeier1", coeff=[1.62153902, 0.0122241457, 0.256287842,
                                            0.0595736775, 1.64447552, 147.468793],
                       desc="SF10", long_desc="N-SF10 (SCHOTT)")
SF11 = RefractionIndex("Sellmeier1", coeff=[1.73759695, 0.013188707, 0.313747346,
                                            0.0623068142, 1.89878101, 155.23629],
                       desc="SF11", long_desc="N-SF11 (SCHOTT)")
SF66 = RefractionIndex("Sellmeier1", coeff=[2.0245976, 0.0147053225, 0.470187196,
                                            0.0692998276, 2.59970433, 161.817601],
                       desc="SF66", long_desc="N-SF66 (SCHOTT)")
SK14 = RefractionIndex("Sellmeier1", coeff=[0.936155374, 0.00461716525, 0.594052018,
                                            0.016885927, 1.04374583, 103.736265],
                       desc="SK14", long_desc="N-SK14 (SCHOTT)")
soda_lime = RefractionIndex("Function",
                            func=lambda wl: 1.5130 - 0.003169 * (wl * 1e-3) ** 2
                            + 0.003962 * (wl * 1e-3) ** -2,
                            desc="Soda Lime", long_desc="Clear soda lime silica window glass")
SSK8 = RefractionIndex("Sellmeier1", coeff=[1.44857867, 0.00869310149, 0.117965926,
                                            0.0421566593, 1.06937528, 111.300666],
                       desc="SSK8", long_desc="N-SSK8 (SCHOTT)")

glasses: list = [BAF10, BAK1, BASF64, BK7, F2, FK51A, fused_silica, K5, LAF2, LAK8, LAK22,
                 LASF9, LASF44, LF5, SF5, SF6, SF10, SF11, SF66, SK14, soda_lime, SSK8]

# plastics -------------------------------------------------------------

CR39 = RefractionIndex("Conrady", coeff=[1.471862713, 1.520790642e-2, 3.555509148e-5],
                       desc="CR39", long_desc="CR-39, PADC, Poly(allyl diglycol carbonate)")
COC = RefractionIndex("Sellmeier2", coeff=[1.045, 0.266, 0.206, 0, 0], desc="COC",
                      long_desc="Topas COC 5013 at 25°C")
COP = RefractionIndex("Sellmeier1", coeff=[1.2969, 0.011721, 0, 0, 0, 0],
                      desc="COP", long_desc="COP (Zeonex E48R)")
Finalite = RefractionIndex("Abbe", n=1.600, V=42, desc="Finalite", long_desc="Sola Finalite")
MR7 = RefractionIndex("Abbe", n=1.660, V=32, desc="MR-7", long_desc="MR-7")
Ormex = RefractionIndex("Abbe", n=1.558, V=32, desc="Ormex", long_desc="Essilor Ormex")
PC = RefractionIndex("Sellmeier1", coeff=[1.4182, 0.021304, 0, 0, 0, 0],
                     desc="PC", long_desc="Polycarbonate")
PDSM = RefractionIndex("Sellmeier1", coeff=[1.0057, 0.013217, 0, 0, 0, 0], desc="PDSM",
                       long_desc="Polydimethylsiloxane")
PEI = RefractionIndex("Data", wls=380 + 10 * np.arange(41),
                      vals=[1.66217, 1.65853, 1.65489, 1.65125, 1.64792, 1.64503, 1.64280, 1.64096,
                            1.63893, 1.63755, 1.63586, 1.63415, 1.63333, 1.63220, 1.63076, 1.62948,
                            1.62900, 1.62795, 1.62746, 1.62653, 1.62629, 1.62609, 1.62439, 1.62401,
                            1.62392, 1.62250, 1.62273, 1.62204, 1.62185, 1.62057, 1.62139, 1.62040,
                            1.62058, 1.61972, 1.61996, 1.61953, 1.61865, 1.61865, 1.61975,
                            1.61784, 1.61865],
                      desc="PEI", long_desc="Polyetherimide")
PET = RefractionIndex("Data", wls=380 + 10 * np.arange(41),
                      vals=[1.61891, 1.61459, 1.61027, 1.60595, 1.60212, 1.59847, 1.59528, 1.59247,
                            1.58988, 1.58716, 1.58496, 1.58304, 1.58111, 1.57927, 1.57769, 1.57630,
                            1.57470, 1.57333, 1.57194, 1.57086, 1.56993, 1.56904, 1.56811, 1.56696,
                            1.56627, 1.56527, 1.56478, 1.56368, 1.56317, 1.56225, 1.56199, 1.56131,
                            1.56052, 1.56013, 1.55933, 1.55868, 1.55854, 1.55817, 1.55795, 1.55723,
                            1.55583],
                      desc="PET", long_desc="Polyethylene terephthalate")
PMMA = RefractionIndex("Sellmeier1", coeff=[0.99654, 0.00787, 0.18964, 0.02191,
                                            0.00411, 3.85727],
                       desc="PMMA", long_desc="Poly(methyl methacrylate)")
PS = RefractionIndex("Sellmeier1", coeff=[1.4435, 0.020216, 0, 0, 0, 0],
                     desc="PS", long_desc="Polystyren")
PVC = RefractionIndex("Data", wls=380 + 10 * np.arange(41),
                      vals=[1.56439, 1.56287, 1.56135, 1.55983, 1.55812, 1.55625, 1.55491, 1.55388,
                            1.55236, 1.55145, 1.55010, 1.54940, 1.54850, 1.54761, 1.54692, 1.54626,
                            1.54533, 1.54493, 1.54389, 1.54325, 1.54275, 1.54238, 1.54137, 1.54114,
                            1.54073, 1.54004, 1.53987, 1.53987, 1.53946, 1.53880, 1.53812, 1.53791,
                            1.53754, 1.53727, 1.53732, 1.53674, 1.53593, 1.53544, 1.53569,
                            1.53528, 1.53526],
                      desc="PVC", long_desc="Polyvinyl chloride")
Spectralite = RefractionIndex("Abbe", n=1.537, V=47, desc="Spectralite", long_desc="Sola Spectralite")

plastics: list = [COC, COP, CR39, Finalite, MR7, Ormex, PC, PDSM, PEI, PET, PMMA, PS, PVC, Spectralite]

# misc media -----------------------------------------------------------

air = RefractionIndex("Constant", n=1.00027784, desc="Air",
                      long_desc="Air at 550nm, 15°C, 1013.25hPa")
BaF2 = RefractionIndex("Sellmeier1", coeff=[0.643356, 0.057789 ** 2, 0.506762, 0.10968 ** 2,
                                            3.8261, 46.3864 ** 2],
                       desc="BaF2", long_desc="BaF2 (Barium fluoride)")
CaF2 = RefractionIndex("Sellmeier1", coeff=[0.5675888, 0.050263605 ** 2, 0.4710914,
                                            0.1003909 ** 2, 3.8484723, 34.649040 ** 2],
                       desc="CaF2", long_desc="CaF2 (Calcium fluoride)")
diamond = RefractionIndex("Sellmeier1", coeff=[0.3306, 0.1750 ** 2, 4.3356, 0.1060 ** 2, 0, 0],
                          desc="Diamond", long_desc="Diamond")
ethanol = RefractionIndex("Sellmeier1", coeff=[0.0165, 9.08, 0.8268, 0.01039, 0, 0],
                          desc="Ethanol", long_desc="C2H5OH (Ethanol)")
ice = RefractionIndex("Data", wls=380 + 10 * np.arange(41),
                      vals=[1.32145, 1.3203, 1.3194, 1.3185, 1.3177, 1.3170, 1.3163, 1.3157,
                            1.3151, 1.3145, 1.3140, 1.3135, 1.3130, 1.3126, 1.3121, 1.3117,
                            1.3114, 1.3110, 1.3106, 1.3103, 1.3100, 1.3097, 1.3094, 1.3091,
                            1.3088, 1.3085, 1.3083, 1.3080, 1.3078, 1.3076, 1.3073, 1.3071,
                            1.3069, 1.3067, 1.3065, 1.3062, 1.3060, 1.3059, 1.3057, 1.3055,
                            1.3053], desc="Ice", long_desc="Water Ice at -7°C")
MgF2 = RefractionIndex("Sellmeier1", coeff=[0.48755108, 0.04338408 ** 2, 0.39875031,
                                            0.09461442 ** 2, 2.3120353, 23.793604 ** 2],
                       desc="MgF2", long_desc="MgF2 (Magnesium fluoride)")
vacuum = RefractionIndex("Constant", n=1.0, desc="Vacuum", long_desc="Vacuum")
water = RefractionIndex("Sellmeier3", coeff=[5.684027565e-1, 5.101829712e-3, 1.726177391e-1,
                                             1.821153936e-2, 2.086189578e-2, 2.620722293e-2,
                                             1.130748688e-1, 1.069792721e1],
                        desc="Water", long_desc="Water at 20.0°C")

misc: list = [air, BaF2, CaF2, diamond, ethanol, ice, MgF2, vacuum, water]

all_presets: list = [*glasses, *plastics, *misc]

"""The torch port's copy of mp3rgain_tpu/ops/coeffs.py, held equal to it by
tests/test_torch_host_copies.py.

ReplayGain 1.0 equal-loudness filter coefficients.

Yule-Walker (10th order) + Butterworth high-pass (2nd order) coefficient
tables for all 12 supported sample rates — constants from the ReplayGain
specification (identical to the reference's tables at
the reference Rust mp3rgain's src/replaygain.rs:106-526 and the canonical
gain_analysis.c).

Also provides the TPU-oriented factorization: the Yule denominator is
factored into five second-order sections (pure-AR cascade) in float64 —
the numerator stays as a single 11-tap FIR — giving an exactly equivalent
filter whose recurrences are individually well-conditioned in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

# Denormal-prevention constant added inside both filter stages
# (reference src/replaygain.rs:528-530).
DENORMAL_PREVENTION = 1e-10

# fmt: off
YULE_A = {
    96000: [1.0, -7.22103125152679, 24.7034187975904, -52.6825833623896,
            77.4825736677539, -82.0074753444205, 63.1566097101925,
            -34.889569769245, 13.2126852760198, -3.09445623301669,
            0.340344741393305],
    88200: [1.0, -7.19001570087017, 24.4109412087159, -51.6306373580801,
            75.3978476863163, -79.4164552507386, 61.0373661948115,
            -33.7446462547014, 12.8168791146274, -3.01332198541437,
            0.223619893831468],
    64000: [1.0, -5.74819833657784, 16.246507961894, -29.9691822642542,
            40.027597579378, -40.3209196052655, 30.8542077487718,
            -17.5965138737281, 7.10690214103873, -1.82175564515191,
            0.223619893831468],
    48000: [1.0, -3.84664617118067, 7.81501653005538, -11.34170355132042,
            13.05504219327545, -12.28759895145294, 9.48293806319790,
            -5.87257861775999, 2.75465861874613, -0.86984376593551,
            0.13919314567432],
    44100: [1.0, -3.47845948550071, 6.36317777566148, -8.54751527471874,
            9.47693607801280, -8.81498681370155, 6.85401540936998,
            -4.39470996079559, 2.19611684890774, -0.75104302451432,
            0.13149317958808],
    32000: [1.0, -2.37898834973084, 2.84868151156327, -2.64577170229825,
            2.23697657451713, -1.67148153367602, 1.00595954808547,
            -0.45953458054983, 0.16378164858596, -0.05032077717131,
            0.02347897407020],
    24000: [1.0, -1.61273165137247, 1.07977492259970, -0.25656257754070,
            -0.16276719120440, -0.22638893773906, 0.39120800788284,
            -0.22138138954925, 0.04500235387352, 0.02005851806501,
            0.00302439095741],
    22050: [1.0, -1.49858979367799, 0.87350271418188, 0.12205022308084,
            -0.80774944671438, 0.47854794562326, -0.12453458140019,
            -0.04067510197014, 0.08333755284107, -0.04237348025746,
            0.02977207319925],
    16000: [1.0, -0.62820619233671, 0.29661783706366, -0.37256372942400,
            0.00213767857124, -0.42029820170918, 0.22199650564824,
            0.00613424350682, 0.06747620744683, 0.05784820375801,
            0.03222754072173],
    12000: [1.0, -1.04800335126349, 0.29156311971249, -0.26806001042947,
            0.00819999645858, 0.45054734505008, -0.33032403314006,
            0.06739368333110, -0.04784254229033, 0.01639907836189,
            0.01807364323573],
    11025: [1.0, -0.51035327095184, -0.31863563325245, -0.20256413484477,
            0.14728154134330, 0.38952639978999, -0.23313271880868,
            -0.05246019024463, -0.02505961724053, 0.02442357316099,
            0.01818801111503],
    8000:  [1.0, -0.25049871956020, -0.43193942311114, -0.03424681017675,
            -0.04678328784242, 0.26408300200955, 0.15113130533216,
            -0.17556493366449, -0.18823009262115, 0.05477720428674,
            0.04704409688120],
}

YULE_B = {
    96000: [0.006471345933032, -0.02567678242161, 0.049805860704367,
            -0.05823001743528, 0.040611847441914, -0.010912036887501,
            -0.00901635868667, 0.012448886238123, -0.007206683749426,
            0.002167156433951, -0.000261819276949],
    88200: [0.015415414474287, -0.07691359399407, 0.196677418516518,
            -0.338855114128061, 0.430094579594561, -0.415015413747894,
            0.304942508151101, -0.166191795926663, 0.063198189938739,
            -0.015003978694525, 0.001748085184539],
    64000: [0.021776466467053, -0.062376961003801, 0.107731165328514,
            -0.150994515142316, 0.170334807313632, -0.157984942890531,
            0.121639833268721, -0.074094040816409, 0.031282852041061,
            -0.00755421235941, 0.00117925454213],
    48000: [0.03857599435200, -0.02160367184185, -0.00123395316851,
            -0.00009291677959, -0.01655260341619, 0.02161526843274,
            -0.02074045215285, 0.00594298065125, 0.00306428023191,
            0.00012025322027, 0.00288463683916],
    44100: [0.05418656406430, -0.02911007808948, -0.00848709379851,
            -0.00851165645469, -0.00834990904936, 0.02245293253339,
            -0.02596338512915, 0.01624864962975, -0.00240879051584,
            0.00674613682247, -0.00187763777362],
    32000: [0.15457299681924, -0.09331049056315, -0.06247880153653,
            0.02163541888798, -0.05588393329856, 0.04781476674921,
            0.00222312597743, 0.03174092540049, -0.01390589421898,
            0.00651420667831, -0.00881362733839],
    24000: [0.30296907319327, -0.22613988682123, -0.08587323730772,
            0.03282930172664, -0.00915702933434, -0.02364141202522,
            -0.00584456039913, 0.06276101321749, -0.00000828086748,
            0.00205861885564, -0.02950134983287],
    22050: [0.33642304856132, -0.25572241425570, -0.11828570177555,
            0.11921148675203, -0.07834489609479, -0.00469977914380,
            -0.00589500224440, 0.05724228140351, 0.00832043980773,
            -0.01635381384540, -0.01760176568150],
    16000: [0.44915256608450, -0.14351757464547, -0.22784394429749,
            -0.01419140100551, 0.04078262797139, -0.12398163381748,
            0.04078565135648, 0.10478503600251, -0.01863887810927,
            -0.03193428438915, 0.00541907748707],
    12000: [0.56619470757641, -0.75464456939302, 0.16242137742230,
            0.16744243493672, -0.18901604199609, 0.30931782841830,
            -0.27562961986224, 0.00647310677246, 0.08647503780351,
            -0.03788984554840, -0.00588215443421],
    11025: [0.58100494960553, -0.53174909058578, -0.14289799034253,
            0.17520704835522, 0.02377945217615, 0.15558449135573,
            -0.25344790059353, 0.01628462406333, 0.06920467763959,
            -0.03721611395801, -0.00749618797172],
    8000:  [0.53648789255105, -0.42163034350696, -0.00275953611929,
            0.04267842219415, -0.10214864179676, 0.14590772289388,
            -0.02459864859345, -0.11202315195388, -0.04060034127000,
            0.04788665548180, -0.02217936801134],
}

BUTTER_A = {
    96000: [1.0, -1.98611621154089, 0.986211929160751],
    88200: [1.0, -1.98488843762334, 0.979389350028798],
    64000: [1.0, -1.97917472731008, 0.979389350028798],
    48000: [1.0, -1.97223372919527, 0.97261396931306],
    44100: [1.0, -1.96977855582618, 0.97022847566350],
    32000: [1.0, -1.95835380975398, 0.95920349965459],
    24000: [1.0, -1.95002759149878, 0.95124613669835],
    22050: [1.0, -1.94561023566527, 0.94705070426118],
    16000: [1.0, -1.92783286977036, 0.93034775234268],
    12000: [1.0, -1.91858953033784, 0.92177618768381],
    11025: [1.0, -1.91542108074780, 0.91885558323625],
    8000:  [1.0, -1.88903307939452, 0.89487434461664],
}

BUTTER_B = {
    96000: [0.99308203517541, -1.98616407035082, 0.99308203517541],
    88200: [0.992472550461293, -1.98494510092258, 0.992472550461293],
    64000: [0.989641019334721, -1.97928203866944, 0.989641019334721],
    48000: [0.98621192462708, -1.97242384925416, 0.98621192462708],
    44100: [0.98500175787242, -1.97000351574484, 0.98500175787242],
    32000: [0.97938932735214, -1.95877865470428, 0.97938932735214],
    24000: [0.97531843204928, -1.95063686409857, 0.97531843204928],
    22050: [0.97316523498161, -1.94633046996323, 0.97316523498161],
    16000: [0.96454515552826, -1.92909031105652, 0.96454515552826],
    12000: [0.96009142950541, -1.92018285901082, 0.96009142950541],
    11025: [0.95856916599601, -1.91713833199203, 0.95856916599601],
    8000:  [0.94597685600279, -1.89195371200558, 0.94597685600279],
}
# fmt: on

SUPPORTED_RATES = tuple(sorted(YULE_A, reverse=True))

# Rates whose published Yule-Walker row is numerically unstable. The
# 88200 Hz coefficients (identical to the reference's table,
# the reference's src/replaygain.rs:145-175) have poles outside the unit
# circle: every direct implementation diverges to inf/NaN within a few
# thousand samples, and in the reference every NaN mean-square window
# lands in histogram bin 2000 via Rust's saturating `NaN as i32 == 0`
# cast (src/replaygain.rs:754-755) — i.e. the analysis degenerates to
# loudness 0.0 dB. The device filter short-circuits these rates to the
# same well-defined result (ops/iir.py) instead of materializing
# overflowing blocked operators.
DEGENERATE_RATES = frozenset({88200})


@dataclass(frozen=True)
class FilterPlan:
    """Equal-loudness filter restructured for blocked device execution.

    The Yule stage is factored into five second-order sections with
    nearest pole/zero pairing (scipy tf2sos) so each biquad is
    individually well-conditioned in float32; the Butterworth high-pass is
    a sixth biquad. `sos` rows are [b0, b1, b2, a1, a2] (a0 == 1).

    Note on the 88200 Hz row: the coefficient table (identical to the
    reference's, src/replaygain.rs:145-175) is numerically unstable at
    88.2 kHz — as is every direct implementation of the same table, the
    reference included; MP3 cannot carry 88.2 kHz audio, so the row is
    only reachable via AAC input and degenerates identically everywhere
    (every diverged RMS window lands in histogram bin 2000 → loudness
    0.0; see DEGENERATE_RATES).
    """

    sample_rate: int
    yule_b: np.ndarray  # (11,)
    yule_sections: np.ndarray  # (5, 2)  [a1, a2] per AR(2) section
    butter_b: np.ndarray  # (3,)
    butter_section: np.ndarray  # (2,)
    sos: np.ndarray  # (6, 5) second-order sections for the full chain


def _factor_ar_sections(a: np.ndarray) -> np.ndarray:
    """Factor a monic degree-10 polynomial into 5 real quadratics."""
    roots = np.roots(a)
    used = np.zeros(len(roots), dtype=bool)
    sections = []
    # Pair complex conjugates; pair leftover reals with nearest real.
    order = np.argsort(-np.abs(roots.imag))
    for i in order:
        if used[i]:
            continue
        r = roots[i]
        used[i] = True
        if abs(r.imag) > 1e-12:
            j = int(np.argmin(np.abs(roots - np.conj(r)) + used * 1e9))
            used[j] = True
            sections.append((-2.0 * r.real, abs(r) ** 2))
        else:
            # nearest unused real root
            cand = [k for k in range(len(roots)) if not used[k] and abs(roots[k].imag) <= 1e-12]
            j = min(cand, key=lambda k: abs(roots[k].real - r.real))
            used[j] = True
            s = roots[j].real
            sections.append((-(r.real + s), r.real * s))
    assert len(sections) == 5
    # Verify the factorization reproduces the original polynomial.
    poly = np.array([1.0])
    for a1, a2 in sections:
        poly = np.convolve(poly, [1.0, a1, a2])
    assert np.allclose(poly, a, atol=1e-10), (poly, a)
    return np.array(sections, dtype=np.float64)


@lru_cache(maxsize=None)
def filter_plan(sample_rate: int) -> FilterPlan:
    if sample_rate not in YULE_A:
        raise ValueError(
            f"Unsupported sample rate: {sample_rate} Hz. Supported rates: "
            + ", ".join(str(r) for r in SUPPORTED_RATES)
        )
    ya = np.array(YULE_A[sample_rate], dtype=np.float64)
    yb = np.array(YULE_B[sample_rate], dtype=np.float64)
    ba = np.array(BUTTER_A[sample_rate], dtype=np.float64)
    bb = np.array(BUTTER_B[sample_rate], dtype=np.float64)

    from scipy.signal import tf2sos

    try:
        yule_sos = tf2sos(yb, ya, pairing="nearest")
    except ValueError:
        # Unstable table row (88200): fall back to default pairing.
        yule_sos = tf2sos(yb, ya)
    butter_sos = np.array([[bb[0], bb[1], bb[2], ba[1], ba[2]]])
    sos = np.concatenate([yule_sos[:, [0, 1, 2, 4, 5]], butter_sos])
    return FilterPlan(
        sample_rate=sample_rate,
        yule_b=yb,
        yule_sections=_factor_ar_sections(ya),
        butter_b=bb,
        butter_section=np.array([ba[1], ba[2]], dtype=np.float64),
        sos=sos,
    )

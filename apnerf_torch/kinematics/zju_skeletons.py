"""SMPL-topology skeleton prior for ZJU-MoCap subjects (port of
``apnerf/kinematics/zju_skeletons.py``).

The reference ships hardcoded per-subject joint tables and the SMPL bone
topology (reference zju_skeletons.py:3-147), read only by the
``smpl_skeleton`` branch of its export (reference run.py:1215-1231, where
upstream hardcodes ``smpl_skeleton = False``); here the export takes it
when a config sets ``pcd_model_and_render.smpl_skeleton``.

Rest-pose joints come from a ``smpl_joints.npy`` next to the subject's
pickle cache (shape [24, 3], already divided by the WIM
``coordinate_scale`` 1.5), else from the built-in table matched on the
subject id in the path; without either the caller uses the automatic
skeletonizer.
"""
from __future__ import annotations

import os
import re

import numpy as np

# SMPL kinematic tree: (parent, child) over the standard 24 joints
# 0 pelvis, 1/2 L/R hip, 3 spine1, 4/5 L/R knee, 6 spine2, 7/8 L/R ankle,
# 9 spine3, 10/11 L/R foot, 12 neck, 13/14 L/R collar, 15 head,
# 16/17 L/R shoulder, 18/19 L/R elbow, 20/21 L/R wrist, 22/23 L/R hand.
# The last two rows follow the reference table (zju_skeletons.py:5-9 after
# its [-1,0] root row is dropped, run.py:1221), which parents the hands to
# joint 15 rather than the wrists — kept verbatim for parity with its
# experiments.
SMPL_BONES = [
    [0, 1], [0, 2], [0, 3], [1, 4], [2, 5], [3, 6], [4, 7], [5, 8],
    [6, 9], [7, 10], [8, 11], [9, 12], [9, 13], [9, 14], [12, 15],
    [13, 16], [14, 17], [16, 18], [17, 19], [18, 20], [19, 21],
    [15, 22], [15, 23],
]

COORDINATE_SCALE = 1.5  # WIM preprocessing scale for ZJU

# Per-subject rest-pose joints (dataset-derived constants; the values
# must match the reference tables, zju_skeletons.py:11-147, to
# reproduce its experiments — already divided by COORDINATE_SCALE).
SUBJECT_JOINTS = {
    "336": np.array([
        [np.float32(0.08997523), np.float32(0.40291798), np.float32(0.61119)],
        [np.float32(0.046691988), np.float32(0.41679668), np.float32(0.55177116)],
        [np.float32(0.09671975), np.float32(0.3521562), np.float32(0.5471429)],
        [np.float32(0.08396252), np.float32(0.39964637), np.float32(0.6858341)],
        [np.float32(0.08752966), np.float32(0.46434554), np.float32(0.31046882)],
        [np.float32(0.06281898), np.float32(0.28236908), np.float32(0.3221291)],
        [np.float32(0.08622453), np.float32(0.41327658), np.float32(0.77181226)],
        [np.float32(0.07296241), np.float32(0.43458974), np.float32(0.047613803)],
        [np.float32(0.03171622), np.float32(0.2208678), np.float32(0.06323553)],
        [np.float32(0.1099655), np.float32(0.4227891), np.float32(0.8029379)],
        [np.float32(0.1496862), np.float32(0.47215685), np.float32(0.014089587)],
        [np.float32(0.092115514), np.float32(0.1643083), np.float32(0.026299879)],
        [np.float32(0.10908867), np.float32(0.41721234), np.float32(0.9145086)],
        [np.float32(0.09367376), np.float32(0.45165375), np.float32(0.85804105)],
        [np.float32(0.12748624), np.float32(0.39883825), np.float32(0.8606839)],
        [np.float32(0.13613296), np.float32(0.4350208), np.float32(1.0173159)],
        [np.float32(0.042333364), np.float32(0.5140059), np.float32(0.8933575)],
        [np.float32(0.16515292), np.float32(0.34159496), np.float32(0.89541763)],
        [np.float32(-0.101364486), np.float32(0.5512597), np.float32(0.79967445)],
        [np.float32(0.22841527), np.float32(0.21753411), np.float32(0.7810212)],
        [np.float32(-0.2133112), np.float32(0.6201826), np.float32(0.6996245)],
        [np.float32(0.3177363), np.float32(0.15109375), np.float32(0.6617592)],
        [np.float32(0.130862), np.float32(0.42525518), np.float32(1.0182935)],
        [np.float32(0.17851748), np.float32(0.4476556), np.float32(1.0484332)],
    ], dtype=np.float32),
    "377": np.array([
        [np.float32(0.035284832), np.float32(0.39721677), np.float32(0.6378674)],
        [np.float32(0.03620482), np.float32(0.4377729), np.float32(0.5754102)],
        [np.float32(0.009804598), np.float32(0.36134306), np.float32(0.56908506)],
        [np.float32(0.0144800665), np.float32(0.40417707), np.float32(0.70918745)],
        [np.float32(0.02686205), np.float32(0.47333035), np.float32(0.3267928)],
        [np.float32(-0.019141395), np.float32(0.32889184), np.float32(0.3330502)],
        [np.float32(0.009250955), np.float32(0.41377625), np.float32(0.7953914)],
        [np.float32(-0.013614405), np.float32(0.46906552), np.float32(0.06320935)],
        [np.float32(-0.05949525), np.float32(0.33084688), np.float32(0.066286534)],
        [np.float32(0.02265302), np.float32(0.40080047), np.float32(0.83063716)],
        [np.float32(0.068205155), np.float32(0.4901036), np.float32(0.026931137)],
        [np.float32(-0.000594314), np.float32(0.272615), np.float32(0.029044645)],
        [np.float32(-0.005050415), np.float32(0.4042134), np.float32(0.93834764)],
        [np.float32(0.02669279), np.float32(0.43269923), np.float32(0.886017)],
        [np.float32(0.00017293745), np.float32(0.37641564), np.float32(0.88602)],
        [np.float32(0.0072100945), np.float32(0.402602), np.float32(1.0456649)],
        [np.float32(0.044009548), np.float32(0.5102687), np.float32(0.92288285)],
        [np.float32(-0.03389738), np.float32(0.3179979), np.float32(0.9215653)],
        [np.float32(0.05408916), np.float32(0.61569595), np.float32(0.7821076)],
        [np.float32(-0.107580654), np.float32(0.25659126), np.float32(0.768209)],
        [np.float32(0.20702432), np.float32(0.5804612), np.float32(0.83620566)],
        [np.float32(0.0021317874), np.float32(0.13528015), np.float32(0.7791168)],
        [np.float32(6.864433e-05), np.float32(0.39422128), np.float32(1.044886)],
        [np.float32(0.047401175), np.float32(0.40263137), np.float32(1.0816385)],
    ], dtype=np.float32),
    "381": np.array([
        [np.float32(0.077497624), np.float32(0.35830715), np.float32(0.5939326)],
        [np.float32(0.06279484), np.float32(0.4014416), np.float32(0.53545845)],
        [np.float32(0.060324952), np.float32(0.32060686), np.float32(0.52415806)],
        [np.float32(0.05967364), np.float32(0.35389522), np.float32(0.66529316)],
        [np.float32(0.119152516), np.float32(0.4623309), np.float32(0.30650818)],
        [np.float32(0.08245749), np.float32(0.3052325), np.float32(0.2931303)],
        [np.float32(0.056835998), np.float32(0.35590795), np.float32(0.7506227)],
        [np.float32(-0.0033912668), np.float32(0.42571512), np.float32(0.08199369)],
        [np.float32(0.039242566), np.float32(0.34043312), np.float32(0.03801754)],
        [np.float32(0.076206125), np.float32(0.34534922), np.float32(0.7835544)],
        [np.float32(0.045079228), np.float32(0.48154783), np.float32(0.030947693)],
        [np.float32(0.11476194), np.float32(0.29882085), np.float32(0.016974347)],
        [np.float32(0.054375455), np.float32(0.3331587), np.float32(0.8909226)],
        [np.float32(0.073335804), np.float32(0.373064), np.float32(0.8405206)],
        [np.float32(0.06520432), np.float32(0.3118561), np.float32(0.8370257)],
        [np.float32(0.086865194), np.float32(0.3360002), np.float32(0.99217653)],
        [np.float32(0.06827749), np.float32(0.44829905), np.float32(0.8824425)],
        [np.float32(0.05235966), np.float32(0.2449618), np.float32(0.8686473)],
        [np.float32(0.048497144), np.float32(0.5669494), np.float32(0.7590261)],
        [np.float32(0.041988235), np.float32(0.114723705), np.float32(0.749553)],
        [np.float32(0.08862963), np.float32(0.54824686), np.float32(0.9140954)],
        [np.float32(0.114569865), np.float32(0.121226825), np.float32(0.89129096)],
        [np.float32(0.08362133), np.float32(0.325549), np.float32(0.9917175)],
        [np.float32(0.13060999), np.float32(0.3509365), np.float32(1.0194409)],
    ], dtype=np.float32),
    "384": np.array([
        [np.float32(0.20803846), np.float32(0.35404587), np.float32(0.66413313)],
        [np.float32(0.1901773), np.float32(0.39541185), np.float32(0.60338825)],
        [np.float32(0.18611985), np.float32(0.31375065), np.float32(0.59492886)],
        [np.float32(0.19385044), np.float32(0.35270408), np.float32(0.73922855)],
        [np.float32(0.18279952), np.float32(0.4324169), np.float32(0.35212627)],
        [np.float32(0.18411438), np.float32(0.29870352), np.float32(0.3530115)],
        [np.float32(0.19622076), np.float32(0.3583727), np.float32(0.8283265)],
        [np.float32(0.15076038), np.float32(0.44533578), np.float32(0.08393165)],
        [np.float32(0.16492018), np.float32(0.30637282), np.float32(0.080225356)],
        [np.float32(0.21727973), np.float32(0.34860694), np.float32(0.8622815)],
        [np.float32(0.22693239), np.float32(0.47496703), np.float32(0.038269494)],
        [np.float32(0.23989646), np.float32(0.27335137), np.float32(0.03750112)],
        [np.float32(0.20300144), np.float32(0.3405808), np.float32(0.9745546)],
        [np.float32(0.21914281), np.float32(0.37940466), np.float32(0.9198763)],
        [np.float32(0.20964329), np.float32(0.31626973), np.float32(0.9192867)],
        [np.float32(0.21620911), np.float32(0.344349), np.float32(1.0830152)],
        [np.float32(0.21822907), np.float32(0.46040908), np.float32(0.9596074)],
        [np.float32(0.19760017), np.float32(0.24734157), np.float32(0.9553225)],
        [np.float32(0.2036963), np.float32(0.6073759), np.float32(0.859672)],
        [np.float32(0.15495421), np.float32(0.093465336), np.float32(0.8654449)],
        [np.float32(0.28093737), np.float32(0.7558897), np.float32(0.838545)],
        [np.float32(0.15067728), np.float32(-0.06409339), np.float32(0.81177217)],
        [np.float32(0.21242397), np.float32(0.33369112), np.float32(1.0818145)],
        [np.float32(0.24706715), np.float32(0.35887602), np.float32(1.1255558)],
    ], dtype=np.float32),
    "387": np.array([
        [np.float32(0.13446198), np.float32(0.28193226), np.float32(0.6308982)],
        [np.float32(0.13024105), np.float32(0.32465354), np.float32(0.5693575)],
        [np.float32(0.108504154), np.float32(0.24602611), np.float32(0.56156725)],
        [np.float32(0.11589768), np.float32(0.28547746), np.float32(0.70384413)],
        [np.float32(0.13513105), np.float32(0.3465313), np.float32(0.31963724)],
        [np.float32(0.08825225), np.float32(0.21707857), np.float32(0.32486603)],
        [np.float32(0.11381795), np.float32(0.2924172), np.float32(0.7912345)],
        [np.float32(0.1140264), np.float32(0.33117256), np.float32(0.05439576)],
        [np.float32(0.07313619), np.float32(0.21936129), np.float32(0.055747572)],
        [np.float32(0.12998407), np.float32(0.2790783), np.float32(0.8258893)],
        [np.float32(0.19896781), np.float32(0.34485245), np.float32(0.02102656)],
        [np.float32(0.12524489), np.float32(0.15291317), np.float32(0.021543046)],
        [np.float32(0.1066674), np.float32(0.27729276), np.float32(0.9356032)],
        [np.float32(0.1345526), np.float32(0.30976626), np.float32(0.88252354)],
        [np.float32(0.111516595), np.float32(0.25109848), np.float32(0.88180834)],
        [np.float32(0.123200856), np.float32(0.27171776), np.float32(1.0424113)],
        [np.float32(0.14866872), np.float32(0.38831303), np.float32(0.9212048)],
        [np.float32(0.082423694), np.float32(0.18864618), np.float32(0.9168837)],
        [np.float32(0.17503817), np.float32(0.4996387), np.float32(0.7870424)],
        [np.float32(0.03723223), np.float32(0.090536125), np.float32(0.7715697)],
        [np.float32(0.33383882), np.float32(0.48825046), np.float32(0.8347013)],
        [np.float32(0.15019755), np.float32(-0.02057256), np.float32(0.8142007)],
        [np.float32(0.1168046), np.float32(0.26255918), np.float32(1.0416414)],
        [np.float32(0.16542272), np.float32(0.27410486), np.float32(1.0762984)],
    ], dtype=np.float32),
}


def load_subject_joints(datadir: str):
    """Rest-pose SMPL joints for a ZJU subject.

    Priority: an explicit ``smpl_joints.npy`` next to the subject cache,
    then the built-in per-subject table (matched on the subject id in the
    path), else None (callers use the automatic skeletonizer)."""
    base = datadir.split(".pickle")[0]
    for cand in (os.path.join(os.path.dirname(base), "smpl_joints.npy"),
                 base + "_smpl_joints.npy"):
        if os.path.exists(cand):
            joints = np.load(cand).astype(np.float32)
            if joints.shape != (24, 3):
                raise ValueError(f"{cand}: SMPL joints of shape "
                                 f"{joints.shape}, expected (24, 3)")
            return joints
    # match the subject id as a standalone number (not a bare substring:
    # a path containing e.g. "20250381" must not select subject 381)
    for sid, joints in SUBJECT_JOINTS.items():
        if re.search(r"(?<!\d)" + sid + r"(?!\d)", datadir):
            print(f"zju_skeletons: matched SMPL joint table for subject {sid}")
            return joints
    return None


def smpl_skeleton_for(datadir: str):
    """Skeleton dict in ``create_skeleton``'s schema, or None if no joint
    table is available (callers then use the automatic skeletonizer)."""
    joints = load_subject_joints(datadir)
    if joints is None:
        return None
    return {
        "skeleton_pcd": joints,
        "joints": joints,
        "root": joints[0],
        "bones": [b for b in SMPL_BONES],
        "pcd": None,
        "weights": None,
    }

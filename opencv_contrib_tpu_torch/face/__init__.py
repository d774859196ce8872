"""Face recognition (the port of opencv_contrib_tpu/face: face-module
parity).

Reference anchors: face/src — EigenFaces (eigen_faces.cpp), FisherFaces
(fisher_faces.cpp), LBPH (lbph_faces.cpp), all `: public FaceRecognizer`
with train/predict/read/write (facerec.cpp:57-66); BIF features (bif.cpp).
Facemark: cascaded shape regression (LBF/Kazemi class) with first-class
training (face/src/facemarkLBF.cpp, face_alignment.cpp), and the AAM.
"""

from opencv_contrib_tpu_torch.face import aam, facemark
from opencv_contrib_tpu_torch.face.bif import bif_features
from opencv_contrib_tpu_torch.face.recognizers import (
    LBPH,
    EigenFaces,
    FisherFaces,
    lbp_image,
)

__all__ = ["EigenFaces", "FisherFaces", "LBPH", "aam", "lbp_image", "facemark", "bif_features"]

from .base import Compose, TransformABC, rng_of, sample_rng
from .normalize import Normalize, NormalizeRangeImage
from .range_image import LoadSemanticKITTIRange, project_range
from .sampling import Sampler, SamplingDatabase
from .multiview import (GlobalRotScaleTransImage, GridMask,
                        MSResizeCropFlipImage, NormalizeMultiviewImage,
                        PadMultiViewImage,
                        PhotoMetricDistortionMultiViewImage,
                        RandomScaleImageMultiViewImage, ResizeCropFlipImage)
from .reader import (LoadImage, LoadMapsFromFiles, LoadPointCloud,
                     RemoveCameraInvisiblePointsKITTI,
                     RemoveCameraInvisiblePointsKITTIV2)
from .target_generator import Gt2SmokeTarget
from .transform import (FilterBBoxOutsideRange, FilterPointOutsideRange,
                        GlobalRotate, GlobalRotScaleTrans, GlobalScale,
                        GlobalTranslate, RandomFlip3D, RandomHorizontalFlip,
                        RandomObjectPerturb, RandomVerticalFlip, SamplePoint,
                        SamplePointByVoxels, ShufflePoint)

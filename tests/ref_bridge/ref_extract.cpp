// Differential-test bridge: compiles the REFERENCE's own feature extraction
// (headers + src/features.cpp included straight from the reference checkout,
// nothing copied into this repo) against the minimal Eigen shim next door,
// and exposes a C ABI for ctypes.
//
// The point type carries its flat scan index alongside xyz, so the returned
// LoamFeatures give index-exact pick lists to diff against the NumPy oracle
// (loam_jax/oracle/oracle.py) and the JAX pipeline — closing the round-2
// trust gap where the bit-faithfulness chain ended at a hand transcription
// of features-inl.h:11-180 / features.cpp:18-70 rather than at the
// reference's own compiled code.
//
// Build (see tests/test_reference_diff.py):
//   c++ -O2 -std=c++17 -shared -fPIC \
//     -I tests/ref_bridge/eigen_shim -I $REF/loam/include \
//     tests/ref_bridge/ref_extract.cpp $REF/loam/src/features.cpp \
//     -o libref_extract.so

#include <cstdint>
#include <vector>

#include "loam/features.h"

namespace {
struct IndexedPoint {
  double x, y, z;
  std::int64_t idx;
};
}  // namespace

extern "C" int ref_extract_features(
    const double* pts,                 // (n, 3) row-major
    std::int64_t n,
    std::int64_t scan_lines, std::int64_t points_per_line,
    double min_range, double max_range,
    std::int64_t neighbor_points, std::int64_t number_sectors,
    std::int64_t max_edge, std::int64_t max_planar,
    double edge_thresh, double planar_thresh,
    double occlusion_thresh, double parallel_thresh,
    std::int64_t* edge_idx, std::int64_t cap_e, std::int64_t* n_edge,
    std::int64_t* planar_idx, std::int64_t cap_p, std::int64_t* n_planar) {
  try {
    std::vector<IndexedPoint> scan(static_cast<size_t>(n));
    for (std::int64_t i = 0; i < n; i++) {
      scan[i] = IndexedPoint{pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], i};
    }
    loam::LidarParams lidar(static_cast<size_t>(scan_lines),
                            static_cast<size_t>(points_per_line), min_range,
                            max_range);
    loam::FeatureExtractionParams fp;
    fp.neighbor_points = static_cast<size_t>(neighbor_points);
    fp.number_sectors = static_cast<size_t>(number_sectors);
    fp.max_edge_feats_per_sector = static_cast<size_t>(max_edge);
    fp.max_planar_feats_per_sector = static_cast<size_t>(max_planar);
    fp.edge_feat_threshold = edge_thresh;
    fp.planar_feat_threshold = planar_thresh;
    fp.occlusion_thresh = occlusion_thresh;
    fp.parallel_thresh = parallel_thresh;

    const auto feats = loam::extractFeatures(scan, lidar, fp);

    std::int64_t ne = 0;
    for (const auto& p : feats.edge_points) {
      if (ne >= cap_e) return -2;
      edge_idx[ne++] = p.idx;
    }
    *n_edge = ne;
    std::int64_t np_ = 0;
    for (const auto& p : feats.planar_points) {
      if (np_ >= cap_p) return -3;
      planar_idx[np_++] = p.idx;
    }
    *n_planar = np_;
    return 0;
  } catch (...) {
    return -1;
  }
}

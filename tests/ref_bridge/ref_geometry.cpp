// Differential-test bridge for the REFERENCE's geometry module: compiles
// src/geometry.cpp straight from the reference checkout (nothing copied
// into this repo) against the Eigen shim next door, and exposes a C ABI for
// ctypes. Pins the compiled reference behaviors `loam_jax/geometry.py`
// must match:
//   - fitLine PCA direction + the DEAD condition-number guard (the
//     reference computes eig(2)/eig(0) without assigning it,
//     geometry.cpp:55-56, so the returned value is always DBL_MAX)
//   - fitPlane least-squares (n, d) + the SIGNED mean residual
//     (geometry.cpp:71)
//   - Pose3d inverse/compose/act/matrix (geometry.cpp:10-29)
//   - pointToLineDistance / pointToPlaneDistance (geometry-inl.h:21-33)
//
// Build (see tests/test_reference_diff_geometry.py):
//   c++ -O2 -std=c++17 -shared -fPIC \
//     -I tests/ref_bridge/eigen_shim -I $REF/loam/include \
//     tests/ref_bridge/ref_geometry.cpp $REF/loam/src/geometry.cpp \
//     -o libref_geometry.so

#include <cstdint>

#include "loam/geometry.h"

namespace {
Eigen::MatrixXd to_matrix(const double* pts, std::int64_t n) {
  Eigen::MatrixXd m(static_cast<int>(n), 3);
  for (std::int64_t i = 0; i < n; i++)
    for (int j = 0; j < 3; j++) m(static_cast<int>(i), j) = pts[3 * i + j];
  return m;
}
Eigen::Vector3d to_vec(const double* p) {
  return Eigen::Vector3d(p[0], p[1], p[2]);
}
// quaternions cross the ABI as (w, x, y, z)
Eigen::Quaterniond to_quat(const double* q) {
  return Eigen::Quaterniond(q[0], q[1], q[2], q[3]);
}
void store_quat(const Eigen::Quaterniond& q, double* out) {
  out[0] = q.w();
  out[1] = q.x();
  out[2] = q.y();
  out[3] = q.z();
}
void store_vec(const Eigen::Vector3d& v, double* out) {
  out[0] = v(0);
  out[1] = v(1);
  out[2] = v(2);
}
}  // namespace

extern "C" {

// (n, 3) points -> line endpoints a, b and the (dead-guard) condition number
int ref_fit_line(const double* pts, std::int64_t n, double* a, double* b,
                 double* cond) {
  const auto [line, c] = loam::geometry_internal::fitLine(to_matrix(pts, n));
  store_vec(line.a, a);
  store_vec(line.b, b);
  *cond = c;
  return 0;
}

// (n, 3) points -> plane (normal, d) and the SIGNED mean residual
int ref_fit_plane(const double* pts, std::int64_t n, double* normal,
                  double* d, double* avg_dist) {
  const auto [plane, ad] =
      loam::geometry_internal::fitPlane(to_matrix(pts, n));
  store_vec(plane.normal, normal);
  *d = plane.d;
  *avg_dist = ad;
  return 0;
}

double ref_point_to_line_distance(const double* p, const double* a,
                                  const double* b) {
  return loam::geometry_internal::pointToLineDistance<double>(
      to_vec(p), to_vec(a), to_vec(b));
}

double ref_point_to_plane_distance(const double* p, const double* normal,
                                   double d) {
  return loam::geometry_internal::pointToPlaneDistance<double>(
      to_vec(p), to_vec(normal), d);
}

int ref_pose_inverse(const double* q, const double* t, double* q_out,
                     double* t_out) {
  const loam::Pose3d inv = loam::Pose3d(to_quat(q), to_vec(t)).inverse();
  store_quat(inv.rotation, q_out);
  store_vec(inv.translation, t_out);
  return 0;
}

int ref_pose_compose(const double* q1, const double* t1, const double* q2,
                     const double* t2, double* q_out, double* t_out) {
  const loam::Pose3d c =
      loam::Pose3d(to_quat(q1), to_vec(t1))
          .compose(loam::Pose3d(to_quat(q2), to_vec(t2)));
  store_quat(c.rotation, q_out);
  store_vec(c.translation, t_out);
  return 0;
}

int ref_pose_act(const double* q, const double* t, const double* p,
                 double* p_out) {
  store_vec(loam::Pose3d(to_quat(q), to_vec(t)).act(to_vec(p)), p_out);
  return 0;
}

// row-major 4x4
int ref_pose_matrix(const double* q, const double* t, double* m_out) {
  const Eigen::Matrix4d m = loam::Pose3d(to_quat(q), to_vec(t)).matrix();
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) m_out[4 * i + j] = m(i, j);
  return 0;
}

}  // extern "C"

// Native COCO evaluation inner loop (bbox), host C++: the port's copy of
// salience_detr_tpu/native/cocoeval.cpp.
//
// pycocotools ships a C backend for the same hot path.  This evaluates one
// (image, category, area-range) cell: crowd-aware greedy IoU matching at T
// thresholds, through a C ABI loaded with ctypes.
//
// Built by salience_detr_torch/native.py::cocoeval_lib:
//   g++ -O3 -shared -fPIC -o libcocoeval.so cocoeval.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// dt: (D,4) xywh sorted by descending score, gt: (G,4) xywh
// gt_iscrowd: (G,), gt_ignore: (G,) precomputed (crowd or out-of-area)
// iou_thrs: (T,)
// out_dt_matched: (T*D) uint8, out_dt_ignore: (T*D) uint8
// gts must be pre-sorted: non-ignored first.
void evaluate_img(
    const double* dt, int64_t D,
    const double* gt, int64_t G,
    const uint8_t* gt_iscrowd,
    const uint8_t* gt_ignore,
    const double* iou_thrs, int64_t T,
    double area_lo, double area_hi,
    uint8_t* out_dt_matched,
    uint8_t* out_dt_ignore) {
  // IoU matrix (D x G); crowd gt -> intersection over dt area
  std::vector<double> ious(static_cast<size_t>(D) * G);
  for (int64_t d = 0; d < D; ++d) {
    const double dx0 = dt[d * 4 + 0], dy0 = dt[d * 4 + 1];
    const double dw = dt[d * 4 + 2], dh = dt[d * 4 + 3];
    const double dx1 = dx0 + dw, dy1 = dy0 + dh;
    const double darea = dw * dh;
    for (int64_t g = 0; g < G; ++g) {
      const double gx0 = gt[g * 4 + 0], gy0 = gt[g * 4 + 1];
      const double gw = gt[g * 4 + 2], gh = gt[g * 4 + 3];
      const double gx1 = gx0 + gw, gy1 = gy0 + gh;
      const double iw = std::max(0.0, std::min(dx1, gx1) - std::max(dx0, gx0));
      const double ih = std::max(0.0, std::min(dy1, gy1) - std::max(dy0, gy0));
      const double inter = iw * ih;
      const double uni = gt_iscrowd[g] ? darea : darea + gw * gh - inter;
      ious[d * G + g] = uni > 1e-12 ? inter / uni : 0.0;
    }
  }

  std::vector<int64_t> gt_match(static_cast<size_t>(T) * G, -1);
  std::vector<int64_t> dt_match(static_cast<size_t>(T) * D, -1);

  for (int64_t t = 0; t < T; ++t) {
    const double thr = iou_thrs[t];
    for (int64_t d = 0; d < D; ++d) {
      int64_t best = -1;
      double best_iou = std::min(thr, 1.0 - 1e-10);
      for (int64_t g = 0; g < G; ++g) {
        if (gt_match[t * G + g] >= 0 && !gt_iscrowd[g]) continue;
        // gts sorted non-ignored first: stop at ignored once matched to real
        if (best >= 0 && !gt_ignore[best] && gt_ignore[g]) break;
        const double iou = ious[d * G + g];
        if (iou < best_iou) continue;
        best_iou = iou;
        best = g;
      }
      if (best >= 0) {
        dt_match[t * D + d] = best;
        gt_match[t * G + best] = d;
      }
    }
  }

  for (int64_t t = 0; t < T; ++t) {
    for (int64_t d = 0; d < D; ++d) {
      const int64_t m = dt_match[t * D + d];
      out_dt_matched[t * D + d] = m >= 0 ? 1 : 0;
      bool ign;
      if (m >= 0) {
        ign = gt_ignore[m] != 0;
      } else {
        const double a = dt[d * 4 + 2] * dt[d * 4 + 3];
        ign = (a < area_lo) || (a > area_hi);
      }
      out_dt_ignore[t * D + d] = ign ? 1 : 0;
    }
  }
}

}  // extern "C"

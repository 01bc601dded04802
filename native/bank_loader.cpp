// Native template-bank loader for linemod_pose_estimation.
//
// The reference loads its banks through cv::FileStorage in C++
// (readLinemod / readLinemodTemplateParams, rgbdDetector.cpp:1668-1749);
// our Python path uses PyYAML, which needs ~1 ms/template on the shipped
// 2652-template bank — too slow for service cold starts at 10k templates.
// This is a purpose-built parser for the OpenCV FileStorage YAML subset the
// banks use (block maps, flow sequences spanning lines, !!opencv-matrix
// nodes), emitting a flat binary blob the ctypes wrapper
// (utils/native.py) turns into numpy arrays.
//
// Blob formats (little-endian):
//   params blob:    int64 n
//                   f64 R[n*9], f64 T[n*3], f32 K[n*9],
//                   f64 D[n], f64 Ori_dist[n], i32 Rect[n*4],
//                   f64 globals[11]  (n_points, angle_step, radius_min,
//                       radius_max, radius_step, width, height, fx, fy,
//                       near, far)
//   templates blob: int64 n_entries, int64 n_features_total,
//                   i32 entry[n_entries*6]  (pyramid_id, width, height,
//                       level, modality_id, n_features) ColorGradient=0,
//                       DepthNormal=1
//                   i32 features[n_features_total*3]  (x, y, label — the
//                       raw cv::linemod Feature::write order; the Python
//                       boundary swaps to internal (y, x, ori))
//                   i32 header[4] (pyramid_levels, n_modalities, T0, T1)
//                   f64 modality_params[2*4]
//                       (weak, num_features, strong, pad) for ColorGradient
//                       (dist, diff, num_features, extract) for DepthNormal

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  std::string text;
  size_t pos = 0;

  bool load(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    text.resize(sz);
    size_t rd = fread(&text[0], 1, sz, f);
    fclose(f);
    return rd == static_cast<size_t>(sz);
  }
};

// Find the value text after "key:" at the given search start; returns the
// position just after the colon, or npos.
size_t find_key(const std::string& t, const std::string& key, size_t from) {
  std::string pat = key + ":";
  size_t p = from;
  while (true) {
    p = t.find(pat, p);
    if (p == std::string::npos) return std::string::npos;
    // Must start a line (possibly indented) and be followed by space/EOL.
    size_t ls = t.rfind('\n', p);
    ls = (ls == std::string::npos) ? 0 : ls + 1;
    bool clean_prefix = true;
    for (size_t i = ls; i < p; ++i)
      if (!isspace(static_cast<unsigned char>(t[i])) && t[i] != '-') {
        clean_prefix = false;
        break;
      }
    char after = p + pat.size() < t.size() ? t[p + pat.size()] : '\n';
    if (clean_prefix && (after == ' ' || after == '\n' || after == '\r'))
      return p + pat.size();
    p += pat.size();
  }
}

double parse_scalar(const std::string& t, size_t vp) {
  return strtod(t.c_str() + vp, nullptr);
}

// Parse a flow sequence "[ a, b, ... ]" (possibly multiline) of numbers.
// If end_out is non-null it receives the position just past the closing ']'.
std::vector<double> parse_flow(const std::string& t, size_t vp,
                               size_t* end_out = nullptr) {
  std::vector<double> out;
  size_t p = t.find('[', vp);
  if (p == std::string::npos) {
    if (end_out) *end_out = std::string::npos;
    return out;
  }
  ++p;
  int depth = 1;
  while (p < t.size() && depth > 0) {
    char c = t[p];
    if (c == ']') {
      --depth;
      ++p;
    } else if (c == '[') {
      ++depth;
      ++p;
    } else if (c == '-' || c == '+' || c == '.' || isdigit(static_cast<unsigned char>(c))) {
      char* end;
      out.push_back(strtod(t.c_str() + p, &end));
      p = end - t.c_str();
    } else {
      ++p;
    }
  }
  if (end_out) *end_out = p;
  return out;
}

// Parse a feature list after "features:".  Two layouts appear:
//   OpenCV FileStorage block sequence (cv::linemod Feature::write):
//       features:
//          - [ 14, 2, 4 ]
//          - [ 22, 2, 4 ]
//   legacy one-line nested flow: "features: [[14, 2, 4], [22, 2, 4]]".
// Returns the flat numbers; fend receives the position after the list.
std::vector<double> parse_features(const std::string& t, size_t fp, size_t* fend) {
  size_t p = t.find_first_not_of(" \t", fp);
  if (p != std::string::npos && t[p] == '[') {
    return parse_flow(t, fp, fend);  // nested flow collects all numbers
  }
  std::vector<double> out;
  // Block sequence: rows of "- [ x, y, l ]".
  while (p != std::string::npos && p < t.size()) {
    p = t.find_first_not_of(" \t\r\n", p);
    if (p == std::string::npos || t[p] != '-') break;
    size_t bp = t.find_first_not_of(" \t", p + 1);
    if (bp == std::string::npos || t[bp] != '[') break;
    size_t end;
    auto row = parse_flow(t, bp, &end);
    for (double v : row) out.push_back(v);
    p = end;
  }
  if (fend) *fend = p == std::string::npos ? fp : p;
  // Empty list "[]" parses through the flow path above; reaching here with
  // no rows means "features: []" on its own line or a truly empty node.
  return out;
}

// Parse an !!opencv-matrix node: find "data:" after vp, return flow numbers.
std::vector<double> parse_matrix(const std::string& t, size_t vp) {
  size_t dp = find_key(t, "data", vp);
  if (dp == std::string::npos) return {};
  return parse_flow(t, dp);
}

uint8_t* make_blob(const std::vector<std::vector<uint8_t>>& parts, int64_t* out_size) {
  int64_t total = 0;
  for (auto& p : parts) total += static_cast<int64_t>(p.size());
  uint8_t* buf = static_cast<uint8_t*>(malloc(total));
  if (!buf) return nullptr;
  int64_t off = 0;
  for (auto& p : parts) {
    memcpy(buf + off, p.data(), p.size());
    off += p.size();
  }
  *out_size = total;
  return buf;
}

template <typename T>
std::vector<uint8_t> as_bytes(const std::vector<T>& v) {
  std::vector<uint8_t> out(v.size() * sizeof(T));
  memcpy(out.data(), v.data(), out.size());
  return out;
}

}  // namespace

extern "C" {

uint8_t* lpe_load_params_blob(const char* path, int64_t* out_size) {
  Reader r;
  if (!r.load(path)) return nullptr;
  const std::string& t = r.text;

  // Count templates by scanning "Template N:" keys.
  int64_t n = 0;
  {
    char key[64];
    while (true) {
      snprintf(key, sizeof(key), "Template %lld", static_cast<long long>(n));
      if (find_key(t, key, 0) == std::string::npos) break;
      ++n;
    }
  }

  std::vector<double> R(n * 9), T(n * 3), D(n), Od(n);
  std::vector<float> K(n * 9);
  std::vector<int32_t> Rect(n * 4);

  size_t cursor = 0;
  for (int64_t i = 0; i < n; ++i) {
    char key[64];
    snprintf(key, sizeof(key), "Template %lld", static_cast<long long>(i));
    size_t tp = find_key(t, key, cursor);
    if (tp == std::string::npos) return nullptr;
    cursor = tp;

    size_t rp = find_key(t, "R", tp);
    auto Rv = parse_matrix(t, rp);
    size_t tp2 = find_key(t, "T", rp);
    auto Tv = parse_matrix(t, tp2);
    size_t kp = find_key(t, "K", tp2);
    auto Kv = parse_matrix(t, kp);
    size_t dp = find_key(t, "D", kp);
    double Dv = parse_scalar(t, dp);
    size_t op = find_key(t, "Ori_dist", dp);
    double Ov = parse_scalar(t, op);
    size_t rcp = find_key(t, "Rect", op);
    auto Rc = parse_flow(t, rcp);
    if (Rv.size() != 9 || Tv.size() != 3 || Kv.size() != 9 || Rc.size() != 4)
      return nullptr;
    for (int j = 0; j < 9; ++j) R[i * 9 + j] = Rv[j];
    for (int j = 0; j < 3; ++j) T[i * 3 + j] = Tv[j];
    for (int j = 0; j < 9; ++j) K[i * 9 + j] = static_cast<float>(Kv[j]);
    D[i] = Dv;
    Od[i] = Ov;
    for (int j = 0; j < 4; ++j) Rect[i * 4 + j] = static_cast<int32_t>(Rc[j]);
  }

  const char* gkeys[11] = {
      "renderer_n_points",     "renderer_angle_step", "renderer_radius_min",
      "renderer_radius_max",   "renderer_radius_step", "renderer_width",
      "renderer_height",       "renderer_focal_length_x",
      "renderer_focal_length_y", "renderer_near",      "renderer_far"};
  std::vector<double> globals(11, 0.0);
  for (int g = 0; g < 11; ++g) {
    size_t gp = find_key(t, gkeys[g], 0);
    if (gp != std::string::npos) globals[g] = parse_scalar(t, gp);
  }

  std::vector<int64_t> hdr = {n};
  return make_blob(
      {as_bytes(hdr), as_bytes(R), as_bytes(T), as_bytes(K), as_bytes(D),
       as_bytes(Od), as_bytes(Rect), as_bytes(globals)},
      out_size);
}

uint8_t* lpe_load_templates_blob(const char* path, int64_t* out_size) {
  Reader r;
  if (!r.load(path)) return nullptr;
  const std::string& t = r.text;

  std::vector<int32_t> entries;   // pyramid_id, w, h, level, modality, nf
  std::vector<int32_t> features;  // x, y, label (raw Feature::write order)

  // Modality order from the top-level "modalities" list's "type:" entries
  // (template entries carry no modality name — cv::linemod TemplatePyramid
  // is the flat list tp[level*num_mod + mod_index], so the index within
  // each pyramid selects from this order).  Searching only the header
  // region (before "classes:") avoids false hits in class ids/comments,
  // and depth-only banks get the right single-modality labeling.
  std::vector<int32_t> mod_order;  // 0 = ColorGradient, 1 = DepthNormal
  {
    size_t classes_pos = t.find("classes:");
    size_t limit = classes_pos == std::string::npos ? t.size() : classes_pos;
    size_t tp_ = 0;
    while (true) {
      size_t vp = find_key(t, "type", tp_);
      if (vp == std::string::npos || vp >= limit) break;
      size_t vs = t.find_first_not_of(' ', vp);
      if (vs != std::string::npos && t.compare(vs, 5, "Depth") == 0)
        mod_order.push_back(1);
      else
        mod_order.push_back(0);
      tp_ = vp;
    }
    if (mod_order.empty()) mod_order.push_back(0);
  }
  int n_mod = static_cast<int>(mod_order.size());

  // Walk template_pyramids entries in order.  find_key returns the position
  // just AFTER "template_id:", so `next` is exactly where the following
  // iteration must resume parsing — assigning it to `idp` (not re-searching
  // from it, which would skip one template per iteration) visits every
  // pyramid exactly once.
  size_t p = find_key(t, "template_pyramids", 0);
  int64_t n_entries = 0;
  size_t idp = (p == std::string::npos) ? std::string::npos
                                        : find_key(t, "template_id", p);
  while (idp != std::string::npos) {
    int32_t pid = static_cast<int32_t>(parse_scalar(t, idp));
    // Entries of this pyramid run until the next template_id (or EOF).
    size_t next = find_key(t, "template_id", idp);
    size_t ep = idp;
    int ecount = 0;
    while (true) {
      size_t wp = find_key(t, "width", ep);
      if (wp == std::string::npos || (next != std::string::npos && wp > next)) break;
      size_t hp = find_key(t, "height", wp);
      size_t lp = find_key(t, "pyramid_level", hp);
      size_t fp = find_key(t, "features", lp);
      if (fp == std::string::npos) return nullptr;
      size_t fend;
      auto fv = parse_features(t, fp, &fend);
      if (fv.size() % 3 != 0) return nullptr;
      entries.push_back(pid);
      entries.push_back(static_cast<int32_t>(parse_scalar(t, wp)));
      entries.push_back(static_cast<int32_t>(parse_scalar(t, hp)));
      entries.push_back(static_cast<int32_t>(parse_scalar(t, lp)));
      entries.push_back(mod_order[ecount % n_mod]);
      entries.push_back(static_cast<int32_t>(fv.size() / 3));
      for (double v : fv) features.push_back(static_cast<int32_t>(v));
      ++n_entries;
      ++ecount;
      ep = fend;
    }
    idp = next;
  }

  // Header bits.  header[1] is a modality BITMASK (bit0 = ColorGradient,
  // bit1 = DepthNormal) so depth-only banks decode correctly.
  std::vector<int32_t> header(4, 0);
  size_t plp = find_key(t, "pyramid_levels", 0);
  header[0] = plp != std::string::npos ? static_cast<int32_t>(parse_scalar(t, plp)) : 2;
  header[1] = 0;
  for (int32_t m : mod_order) header[1] |= (m == 1) ? 2 : 1;
  size_t tpp = find_key(t, "T", 0);
  auto tv = parse_flow(t, tpp);
  header[2] = tv.size() > 0 ? static_cast<int32_t>(tv[0]) : 5;
  header[3] = tv.size() > 1 ? static_cast<int32_t>(tv[1]) : 8;

  std::vector<double> mparams(8, 0.0);
  size_t cg = t.find("ColorGradient");
  if (cg != std::string::npos) {
    size_t wkp = find_key(t, "weak_threshold", cg);
    size_t nfp = find_key(t, "num_features", cg);
    size_t stp = find_key(t, "strong_threshold", cg);
    if (wkp != std::string::npos) mparams[0] = parse_scalar(t, wkp);
    if (nfp != std::string::npos) mparams[1] = parse_scalar(t, nfp);
    if (stp != std::string::npos) mparams[2] = parse_scalar(t, stp);
  }
  size_t dn = t.find("type: DepthNormal");
  if (dn != std::string::npos) {
    size_t dtp = find_key(t, "distance_threshold", dn);
    size_t dfp = find_key(t, "difference_threshold", dn);
    size_t nfp = find_key(t, "num_features", dn);
    size_t exp_ = find_key(t, "extract_threshold", dn);
    if (dtp != std::string::npos) mparams[4] = parse_scalar(t, dtp);
    if (dfp != std::string::npos) mparams[5] = parse_scalar(t, dfp);
    if (nfp != std::string::npos) mparams[6] = parse_scalar(t, nfp);
    if (exp_ != std::string::npos) mparams[7] = parse_scalar(t, exp_);
  }

  std::vector<int64_t> hdr = {n_entries, static_cast<int64_t>(features.size() / 3)};
  return make_blob(
      {as_bytes(hdr), as_bytes(entries), as_bytes(features), as_bytes(header),
       as_bytes(mparams)},
      out_size);
}

void lpe_free(uint8_t* p) { free(p); }

}  // extern "C"

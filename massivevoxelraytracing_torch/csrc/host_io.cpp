// Host I/O decoders of the port: Radiance RGBE scanlines (new-style RLE
// and flat) and OBJ triangle soups. A copy of the JAX package's native
// host code for these two readers, under the port's own names; the plain
// versions are utils/hdr.py::decode_plain and utils/objio.py::load_obj_plain.
// Plain C ABI for ctypes; built by utils/host_build.py with
// -ffp-contract=off and no -march.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// pix: raw bytes after the resolution line; out: float32 [h*w*3].
// Returns 0 on success, a negative code on a truncated or malformed file.
int32_t hako_hdr_decode(const uint8_t* pix, int64_t n, int32_t w, int32_t h,
                        float* out) {
    int64_t p = 0;
    std::vector<uint8_t> row((size_t)w * 4);
    for (int y = 0; y < h; y++) {
        if (n - p >= 4 && pix[p] == 2 && pix[p + 1] == 2 &&
            ((pix[p + 2] << 8) | pix[p + 3]) == w) {
            p += 4;
            for (int c = 0; c < 4; c++) {
                int x = 0;
                while (x < w) {
                    if (p >= n) return -1;
                    int cnt = pix[p++];
                    if (cnt > 128) {
                        cnt -= 128;
                        if (p >= n || x + cnt > w) return -2;
                        for (int k = 0; k < cnt; k++) row[(size_t)(x + k) * 4 + c] = pix[p];
                        p++;
                        x += cnt;
                    } else {
                        if (p + cnt > n || x + cnt > w) return -3;
                        for (int k = 0; k < cnt; k++) row[(size_t)(x + k) * 4 + c] = pix[p + k];
                        p += cnt;
                        x += cnt;
                    }
                }
            }
        } else {
            if (p + 4 * (int64_t)w > n) return -4;
            for (int x = 0; x < w; x++)
                for (int c = 0; c < 4; c++) row[(size_t)x * 4 + c] = pix[p + (int64_t)x * 4 + c];
            p += 4 * (int64_t)w;
        }
        for (int x = 0; x < w; x++) {
            uint8_t e = row[(size_t)x * 4 + 3];
            float scale = e ? ldexpf(1.0f, (int)e - 136) : 0.0f;
            for (int c = 0; c < 3; c++)
                out[((size_t)y * w + x) * 3 + c] =
                    e ? (row[(size_t)x * 4 + c] + 0.5f) * scale : 0.0f;
        }
    }
    return 0;
}

// OBJ triangle soup (v / f lines, fan triangulation, 1-based or negative
// indices, /vt/vn suffixes skipped). First call with tris == nullptr to get
// the triangle count; then again with a buffer of n_tris * 9 floats.
// Returns the triangle count, or -1 if it exceeds cap_tris.
int64_t hako_obj_parse(const char* text, int64_t len, float* tris,
                       int64_t cap_tris) {
    std::vector<float> verts;
    verts.reserve(1 << 16);
    int64_t n_out = 0;
    const char* p = text;
    const char* end = text + len;
    std::vector<int64_t> face;
    while (p < end) {
        const char* eol = (const char*)memchr(p, '\n', end - p);
        if (!eol) eol = end;
        if (p[0] == 'v' && p[1] == ' ') {
            char* q = (char*)p + 2;
            float x = strtof(q, &q);
            float y = strtof(q, &q);
            float z = strtof(q, &q);
            verts.push_back(x); verts.push_back(y); verts.push_back(z);
        } else if (p[0] == 'f' && p[1] == ' ') {
            face.clear();
            const char* q = p + 2;
            while (q < eol) {
                while (q < eol && *q == ' ') q++;
                if (q >= eol) break;
                char* qe;
                long idx = strtol(q, &qe, 10);
                if (qe == q) break;
                q = qe;
                while (q < eol && *q != ' ') q++;  // skip /vt/vn
                int64_t nv = (int64_t)verts.size() / 3;
                face.push_back(idx > 0 ? idx - 1 : nv + idx);
            }
            for (size_t k = 1; k + 1 < face.size(); k++) {
                if (tris) {
                    if (n_out >= cap_tris) return -1;
                    float* t = tris + n_out * 9;
                    const int64_t ids[3] = {face[0], face[k], face[k + 1]};
                    for (int j = 0; j < 3; j++) {
                        t[j * 3 + 0] = verts[(size_t)ids[j] * 3 + 0];
                        t[j * 3 + 1] = verts[(size_t)ids[j] * 3 + 1];
                        t[j * 3 + 2] = verts[(size_t)ids[j] * 3 + 2];
                    }
                }
                n_out++;
            }
        }
        p = eol + 1;
    }
    return n_out;
}

}  // extern "C"
